// K1: routed_apply for Hopper (sm_90a). Replaces the Pallas kernel
// lilac_tpu/kernels/routed.py:_routed_kernel / routed_apply.
//
// Computes B gather networks over one shared input table of m slots:
// for each stage s, y[i] <- mask_s[i] ? y[partner_s(i)] : y[i], with
//   xor    d: partner(i) = i ^ d
//   shift  d: partner(i) = (i - d) mod m      (cyclic over the flat table)
//   shiftl d: partner(i) = (i + d) mod m
// The masks come bit-packed, 8 stages per byte plane: bit s%8 of byte
// masks[b, s/8, i] is stage s's switch for slot i of net b.
//
// Design. A stage reads the whole previous stage's output (distances reach
// m/2) and thread blocks run in no order, so every stage is its own launch
// and the table ping-pongs between two buffers in device memory, never in
// place. Stage 0 reads the one shared x table for all B nets (net stride
// 0); no B copies of x are made. The kernel only moves words: it is
// instantiated on the word width (32 or 64 bit) and the plane count (one
// plane, or a df64 (hi, lo) pair routed through identical switches), so the
// result is bit-identical to the plain version whatever the values are.
//
// Bound: bytes. Per stage each thread reads 4 slots and 4 mask bytes with
// vector loads, reads a partner only where the switch is set, and writes 4
// slots. At the NPB class-C shape (m = 2^18, B = 10, df64) a stage moves
// about 45 MB, most of which the 50 MB L2 can hold between stages. Fusing
// runs of short-distance stages in shared memory is the obvious next step.
//
// Limits: m a power of two and a multiple of 1024, B <= 65535 (grid.y),
// indices are 64-bit. Nothing else: the table lives in device memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum { KIND_XOR = 0, KIND_SHIFT = 1, KIND_SHIFTL = 2, KIND_COPY = 3 };

template <typename T>
struct alignas(sizeof(T) * 4) Quad {
  T v[4];
};

template <typename T>
__device__ __forceinline__ void route4(const T* __restrict__ src,
                                       T* __restrict__ dst, uint32_t mw,
                                       int bit, int kind, long long d,
                                       long long i0, long long m) {
  Quad<T> q = *reinterpret_cast<const Quad<T>*>(src + i0);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if ((mw >> (8 * j + bit)) & 1u) {
      const long long i = i0 + j;
      long long p;
      if (kind == KIND_XOR) {
        p = i ^ d;
      } else if (kind == KIND_SHIFT) {
        p = (i - d) & (m - 1);
      } else {
        p = (i + d) & (m - 1);
      }
      q.v[j] = src[p];
    }
  }
  *reinterpret_cast<Quad<T>*>(dst + i0) = q;
}

// One stage over all B nets. sstride is the distance in words between two
// nets in the source (0 for the shared input table of stage 0, m after).
template <typename T, int NP>
__global__ void routed_stage_kernel(const T* __restrict__ s0,
                                    const T* __restrict__ s1,
                                    long long sstride, T* __restrict__ d0,
                                    T* __restrict__ d1,
                                    const uint8_t* __restrict__ mask,
                                    long long mstride, int bit, int kind,
                                    long long d, long long m) {
  const long long i0 =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (i0 >= m) return;
  const long long b = blockIdx.y;
  uint32_t mw = 0;
  if (kind != KIND_COPY) {
    mw = *reinterpret_cast<const uint32_t*>(mask + b * mstride + i0);
  }
  route4<T>(s0 + b * sstride, d0 + b * m, mw, bit, kind, d, i0, m);
  if (NP == 2) {
    route4<T>(s1 + b * sstride, d1 + b * m, mw, bit, kind, d, i0, m);
  }
}

template <typename T, int NP>
cudaError_t run_network(const T* x0, const T* x1, T* out0, T* out1, T* tmp0,
                        T* tmp1, const uint8_t* masks, int B, int P,
                        long long m, int S, const int* kinds,
                        const long long* dists, cudaStream_t stream) {
  const int threads = 256;
  dim3 grid(static_cast<unsigned>((m / 4 + threads - 1) / threads),
            static_cast<unsigned>(B));
  if (S == 0) {
    routed_stage_kernel<T, NP><<<grid, threads, 0, stream>>>(
        x0, x1, 0, out0, out1, masks, 0, 0, KIND_COPY, 0, m);
    return cudaGetLastError();
  }
  const T* s0 = x0;
  const T* s1 = x1;
  long long sstride = 0;
  for (int s = 0; s < S; ++s) {
    // the last stage must land in `out`: stages alternate backwards from it
    const bool to_out = ((S - 1 - s) % 2) == 0;
    T* d0 = to_out ? out0 : tmp0;
    T* d1 = to_out ? out1 : tmp1;
    routed_stage_kernel<T, NP><<<grid, threads, 0, stream>>>(
        s0, s1, sstride, d0, d1, masks + static_cast<long long>(s / 8) * m,
        static_cast<long long>(P) * m, s % 8, kinds[s], dists[s], m);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    s0 = d0;
    s1 = d1;
    sstride = m;
  }
  return cudaSuccess;
}

}  // namespace

// x0/x1: input planes of m words (x1 unused when nplanes == 1).
// out0/out1, tmp0/tmp1: [B, m] words each; the result is in out.
// masks: [B, P, m] bytes. kinds/dists: host arrays of S entries.
// esize: 4 or 8 bytes per word. Returns the cudaError_t of the launches.
extern "C" int lilac_routed_apply(const void* x0, const void* x1, int nplanes,
                                  int esize, void* out0, void* out1,
                                  void* tmp0, void* tmp1, const void* masks,
                                  int B, int P, long long m, int S,
                                  const int* kinds, const long long* dists,
                                  void* stream) {
  if (m < 1024 || (m & (m - 1)) != 0 || B < 1 || B > 65535 || S < 0 ||
      (S > 0 && P != (S + 7) / 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int s = 0; s < S; ++s) {
    if (kinds[s] < KIND_XOR || kinds[s] > KIND_SHIFTL || dists[s] < 1 ||
        dists[s] >= m) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* mk = static_cast<const uint8_t*>(masks);
  cudaError_t err = cudaErrorInvalidValue;
  if (esize == 4 && nplanes == 1) {
    err = run_network<uint32_t, 1>(
        static_cast<const uint32_t*>(x0), nullptr,
        static_cast<uint32_t*>(out0), nullptr, static_cast<uint32_t*>(tmp0),
        nullptr, mk, B, P, m, S, kinds, dists, st);
  } else if (esize == 4 && nplanes == 2) {
    err = run_network<uint32_t, 2>(
        static_cast<const uint32_t*>(x0), static_cast<const uint32_t*>(x1),
        static_cast<uint32_t*>(out0), static_cast<uint32_t*>(out1),
        static_cast<uint32_t*>(tmp0), static_cast<uint32_t*>(tmp1), mk, B, P,
        m, S, kinds, dists, st);
  } else if (esize == 8 && nplanes == 1) {
    err = run_network<unsigned long long, 1>(
        static_cast<const unsigned long long*>(x0), nullptr,
        static_cast<unsigned long long*>(out0), nullptr,
        static_cast<unsigned long long*>(tmp0), nullptr, mk, B, P, m, S, kinds,
        dists, st);
  } else if (esize == 8 && nplanes == 2) {
    err = run_network<unsigned long long, 2>(
        static_cast<const unsigned long long*>(x0),
        static_cast<const unsigned long long*>(x1),
        static_cast<unsigned long long*>(out0),
        static_cast<unsigned long long*>(out1),
        static_cast<unsigned long long*>(tmp0),
        static_cast<unsigned long long*>(tmp1), mk, B, P, m, S, kinds, dists,
        st);
  }
  return static_cast<int>(err);
}
