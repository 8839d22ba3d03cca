// K2: dfmulred for Hopper (sm_90a). Replaces the Pallas kernel
// lilac_tpu/kernels/dfmulred.py:_kern / _dfmulred_call / dfmulred.
//
// Computes y[r] = sum_k df(v)[k, r] * df(x)[k, r] over column-major [K, R]
// planes of (hi, lo) f32 pairs, by Ogita-Rump-Oishi dot2: TwoProd per
// term, TwoSum into the high accumulator, first-order terms compensated in
// a running low part; the output is the (hi, lo) pair of TwoSum(s, c).
//
// Design. One grid a product: a container's chunks (every chunk of every
// net of a single-table plan, or of one packed group of a hierarchical
// plan) are cut into thread blocks of kRows consecutive rows of one chunk,
// listed once per container in a device table (kernels/dfmulred.py:
// ChunkTable), and each block writes its rows straight into the product's
// concatenated output planes: no launch a chunk and no concatenation after
// them. One thread per output row and a run-time loop over K: with the
// column-major [K, R] layout of a chunk neighbouring threads read
// neighbouring addresses, so every load is coalesced and nothing is staged
// in shared memory. The K loop issues the loads of four terms before their
// arithmetic; the terms are still summed in order k = 0, 1, ... The v
// planes may be given with an element stride of 2, the (hi, lo) pairs of
// an interleaved [.., 2] value array, read in place as one 8-byte load.
//
// Bound: bytes (16 bytes read per term against about 30 f32 operations).
//
// Exact rounding. Every step of the error-free transformations must be
// the correctly rounded f32 result of that one operation. nvcc contracts
// a*b+c into an FMA by default, which would break the Dekker split
// (t - a after t = 4097*a) and the Knuth sum (s - a after s = a + b). So
// every EFT step is written with the __f*_rn intrinsics, which the
// compiler never contracts, and the build passes --fmad=false as well.
// lilac_eft_probe exposes the same two device functions so that a run on
// the card can prove them exact against f64.

#include <cuda_runtime.h>
#include <stdint.h>

// two_sum, split and Dekker's two_prod: the same sequences as the plain
// version, so that the two agree bit for bit. (__fmaf_rn(a, b, -p) gives
// the same TwoProd error term in one instruction; the kernel is bound by
// bytes, so the longer form costs nothing.)
#include "df_eft.cuh"

namespace {

constexpr int kRows = 256;  // rows of one thread block, one a thread

// One thread block's rows: n consecutive rows of one chunk, the first at
// slot v0 of the value and x planes (its term k at v0 + k * R, R the
// chunk's rows) and at row y0 of the output planes; kn = K << 32 | n.
struct RowBlock {
  long long v0, y0, R, kn;
};

// one term of the dot2 sum: s + c += df(a) * df(b)
__device__ __forceinline__ void dot2_term(float a_h, float a_l, float b_h,
                                          float b_l, float& s, float& c) {
  float p, ep, es;
  two_prod(a_h, b_h, p, ep);
  // first-order cross terms of the df x df product
  ep = __fadd_rn(ep, __fadd_rn(__fmul_rn(a_h, b_l), __fmul_rn(a_l, b_h)));
  two_sum(s, p, s, es);
  c = __fadd_rn(c, __fadd_rn(es, ep));
}

// PAIR: v element i is the float2 (hi, lo) at vh + 2 i (vl unused);
// otherwise vh[i * vstride] and vl[i * vstride]. blocks: the RowBlock of
// each thread block, or null for one chunk [K, R] = `one`, cut here.
template <bool PAIR>
__global__ void __launch_bounds__(kRows)
    dfmulred_kernel(const float* __restrict__ vh, const float* __restrict__ vl,
                    long long vstride, const float* __restrict__ xh,
                    const float* __restrict__ xl, float* __restrict__ yh,
                    float* __restrict__ yl, const RowBlock* __restrict__ blocks,
                    RowBlock one) {
  long long v0, y0, R;
  int K, n;
  if (blocks != nullptr) {
    const longlong2 a = reinterpret_cast<const longlong2*>(blocks + blockIdx.x)[0];
    const longlong2 b = reinterpret_cast<const longlong2*>(blocks + blockIdx.x)[1];
    v0 = a.x;
    y0 = a.y;
    R = b.x;
    K = static_cast<int>(b.y >> 32);
    n = static_cast<int>(b.y & 0xffffffffll);
  } else {
    const long long r0 = static_cast<long long>(blockIdx.x) * kRows;
    v0 = one.v0 + r0;
    y0 = one.y0 + r0;
    R = one.R;
    K = static_cast<int>(one.kn >> 32);
    n = R - r0 < kRows ? static_cast<int>(R - r0) : kRows;
  }
  if (static_cast<int>(threadIdx.x) >= n) return;
  const long long i0 = v0 + threadIdx.x;
  float s = 0.0f, c = 0.0f;
  int k = 0;
  for (; k + 4 <= K; k += 4) {
    float ah[4], al[4], bh[4], bl[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long i = i0 + (k + j) * R;
      if constexpr (PAIR) {
        const float2 v = reinterpret_cast<const float2*>(vh)[i];
        ah[j] = v.x;
        al[j] = v.y;
      } else {
        ah[j] = vh[i * vstride];
        al[j] = vl[i * vstride];
      }
      bh[j] = xh[i];
      bl[j] = xl[i];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) dot2_term(ah[j], al[j], bh[j], bl[j], s, c);
  }
  for (; k < K; ++k) {
    const long long i = i0 + k * R;
    float a_h, a_l;
    if constexpr (PAIR) {
      const float2 v = reinterpret_cast<const float2*>(vh)[i];
      a_h = v.x;
      a_l = v.y;
    } else {
      a_h = vh[i * vstride];
      a_l = vl[i * vstride];
    }
    dot2_term(a_h, a_l, xh[i], xl[i], s, c);
  }
  float hi, lo;
  two_sum(s, c, hi, lo);
  yh[y0 + threadIdx.x] = hi;
  yl[y0 + threadIdx.x] = lo;
}

__global__ void eft_probe_kernel(const float* __restrict__ a,
                                 const float* __restrict__ b,
                                 float* __restrict__ out, long long n) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s, es, p, ep;
  two_sum(a[i], b[i], s, es);
  two_prod(a[i], b[i], p, ep);
  out[i] = s;
  out[n + i] = es;
  out[2 * n + i] = p;
  out[3 * n + i] = ep;
}

cudaError_t launch(const float* vh, const float* vl, long long vstride,
                   const float* xh, const float* xl, float* yh, float* yl,
                   const RowBlock* blocks, const RowBlock& one,
                   long long nblocks, void* stream) {
  if (vstride != 1 && vstride != 2) return cudaErrorInvalidValue;
  if (nblocks <= 0) return cudaSuccess;
  if (nblocks > 0x7fffffffll) return cudaErrorInvalidValue;
  const bool pair = vstride == 2 && vl == vh + 1 &&
                    reinterpret_cast<uintptr_t>(vh) % 8 == 0;
  const unsigned grid = static_cast<unsigned>(nblocks);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (pair) {
    dfmulred_kernel<true><<<grid, kRows, 0, cs>>>(vh, vl, vstride, xh, xl, yh,
                                                  yl, blocks, one);
  } else {
    dfmulred_kernel<false><<<grid, kRows, 0, cs>>>(vh, vl, vstride, xh, xl, yh,
                                                   yl, blocks, one);
  }
  return cudaGetLastError();
}

}  // namespace

// One chunk: v element (k, r) is at vh[(k*R + r) * vstride]; x and y are
// contiguous.
extern "C" int lilac_dfmulred(const float* vh, const float* vl,
                              long long vstride, const float* xh,
                              const float* xl, float* yh, float* yl, int K,
                              long long R, void* stream) {
  if (K < 0 || R < 0) return static_cast<int>(cudaErrorInvalidValue);
  const RowBlock one = {0, 0, R, static_cast<long long>(K) << 32};
  return static_cast<int>(launch(vh, vl, vstride, xh, xl, yh, yl, nullptr, one,
                                 (R + kRows - 1) / kRows, stream));
}

// A whole product: `blocks` is a device array of nblocks RowBlocks (four
// int64 each, 16-byte aligned) over the value planes (element stride
// vstride), the x planes and the output planes, whose bounds the caller
// checked when it built the table.
extern "C" int lilac_dfmulred_chunks(const float* vh, const float* vl,
                                     long long vstride, const float* xh,
                                     const float* xl, float* yh, float* yl,
                                     const void* blocks, long long nblocks,
                                     void* stream) {
  if (blocks == nullptr || reinterpret_cast<uintptr_t>(blocks) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const RowBlock none = {0, 0, 0, 0};
  return static_cast<int>(launch(vh, vl, vstride, xh, xl, yh, yl,
                                 static_cast<const RowBlock*>(blocks), none,
                                 nblocks, stream));
}

// out is [4, n]: rows s, e_sum, p, e_prod of TwoSum(a, b) and TwoProd(a, b).
extern "C" int lilac_eft_probe(const float* a, const float* b, float* out,
                               long long n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  eft_probe_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, out, n);
  return static_cast<int>(cudaGetLastError());
}
