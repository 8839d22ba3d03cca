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
// Bound: bytes. A call must read the shared input table and the masks once
// and write B tables; at the NPB class-C shape (m = 2^18, B = 10, a df64
// pair, 68 stages in 9 mask planes) that is 47 MB, 0.014 ms at 3.35 TB/s.
// The first design ran one grid per stage (every stage's partner may lie
// anywhere in the table and blocks run in no order), so each of the 68
// stages moved the whole [B, m] table through device memory and L2.
//
// Design. The stage schedule is cut on the host into a few passes that each
// stay inside a tile of T slots held in shared memory (tile_pass.cuh,
// kernels/routed.py:routed_passes): low passes over contiguous tiles (xor
// stages, or runs of shifts over the tile plus their halo), high passes over
// tiles that hold every high address bit (xor and shifts by multiples of
// T). Class C's 68 stages become 6 grids. T is the largest power of two
// whose worst pass (a window of 2T slots with 3 mask planes) fits the
// opt-in shared memory: 2^13 for a df64 pair, 2^14 for one f32 plane, 2^12
// for an f64 pair (kernels/routed.py:routed_tile); the wrapper passes it
// and the launcher refuses one that does not fit. The one-stage kernel
// below is still the pass for a stage with d >= T where m > T^2/4 (a table
// of more than 2^24 slots at T = 2^13); no NPB or Parboil plan has one.
// Passes ping-pong between two [B, m] buffers, the last one landing in
// `out`; the first reads the one shared x table for all B nets (net stride
// 0), so no B copies of x are made. The kernels only move words: they are
// instantiated on the word width (32 or 64 bit) and the plane count (one
// plane, or a df64 (hi, lo) pair routed through identical switches), so the
// result is bit-identical to the plain version whatever the values are.
//
// Limits: m a power of two and a multiple of 1024, B <= 65535 (grid.y),
// T a power of two >= 128. Nothing bounds m: a table beyond T^2/4 slots
// runs its long stages one grid each.

#include <cuda_runtime.h>
#include <stdint.h>

#include <vector>

#include "tile_pass.cuh"

namespace {

using lilac_tiles::KIND_SHIFT;
using lilac_tiles::KIND_SHIFTL;
using lilac_tiles::KIND_XOR;
using lilac_tiles::Quad;
enum { KIND_COPY = 3 };

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
                        const long long* dists, int tile, int npass,
                        const int* pkind, const int* pstart,
                        cudaStream_t stream) {
  const int threads = 256;
  dim3 grid(static_cast<unsigned>((m / 4 + threads - 1) / threads),
            static_cast<unsigned>(B));
  if (S == 0) {
    routed_stage_kernel<T, NP><<<grid, threads, 0, stream>>>(
        x0, x1, 0, out0, out1, masks, 0, 0, KIND_COPY, 0, m);
    return cudaGetLastError();
  }
  if (npass < 1 || npass > S) return cudaErrorInvalidValue;
  std::vector<lilac_tiles::TilePass> ps(npass);
  cudaError_t err = lilac_tiles::plan_passes(
      ps.data(), npass, pkind, pstart, S, kinds, dists, m, tile, false, NP,
      static_cast<int>(sizeof(T)));
  if (err != cudaSuccess) return err;
  const long long mstride = static_cast<long long>(P) * m;
  const T* s0 = x0;
  const T* s1 = x1;
  long long sstride = 0;
  for (int q = 0; q < npass; ++q) {
    // the last pass must land in `out`: passes alternate backwards from it
    const bool to_out = ((npass - 1 - q) % 2) == 0;
    T* d0 = to_out ? out0 : tmp0;
    T* d1 = to_out ? out1 : tmp1;
    if (ps[q].n == 0) {
      const int s = pstart[q];
      routed_stage_kernel<T, NP><<<grid, threads, 0, stream>>>(
          s0, s1, sstride, d0, d1, masks + static_cast<long long>(s / 8) * m,
          mstride, s % 8, kinds[s], dists[s], m);
      err = cudaGetLastError();
    } else {
      err = lilac_tiles::launch_tile_pass<T, NP, lilac_tiles::MODE_FWD>(
          ps[q], s0, s1, sstride, d0, d1, masks, mstride, m, B, stream);
    }
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
// esize: 4 or 8 bytes per word. tile: T; pkind/pstart: the npass passes of
// kernels/routed.py:routed_passes (kind 0 low, 1 high, 2 stage; first
// stage). Returns the cudaError_t of the launches (cudaErrorInvalidValue,
// nothing launched, for a pass list that does not fit).
extern "C" int lilac_routed_apply(const void* x0, const void* x1, int nplanes,
                                  int esize, void* out0, void* out1,
                                  void* tmp0, void* tmp1, const void* masks,
                                  int B, int P, long long m, int S,
                                  const int* kinds, const long long* dists,
                                  int tile, int npass, const int* pkind,
                                  const int* pstart, void* stream) {
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
        nullptr, mk, B, P, m, S, kinds, dists, tile, npass, pkind, pstart, st);
  } else if (esize == 4 && nplanes == 2) {
    err = run_network<uint32_t, 2>(
        static_cast<const uint32_t*>(x0), static_cast<const uint32_t*>(x1),
        static_cast<uint32_t*>(out0), static_cast<uint32_t*>(out1),
        static_cast<uint32_t*>(tmp0), static_cast<uint32_t*>(tmp1), mk, B, P,
        m, S, kinds, dists, tile, npass, pkind, pstart, st);
  } else if (esize == 8 && nplanes == 1) {
    err = run_network<unsigned long long, 1>(
        static_cast<const unsigned long long*>(x0), nullptr,
        static_cast<unsigned long long*>(out0), nullptr,
        static_cast<unsigned long long*>(tmp0), nullptr, mk, B, P, m, S, kinds,
        dists, tile, npass, pkind, pstart, st);
  } else if (esize == 8 && nplanes == 2) {
    err = run_network<unsigned long long, 2>(
        static_cast<const unsigned long long*>(x0),
        static_cast<const unsigned long long*>(x1),
        static_cast<unsigned long long*>(out0),
        static_cast<unsigned long long*>(out1),
        static_cast<unsigned long long*>(tmp0),
        static_cast<unsigned long long*>(tmp1), mk, B, P, m, S, kinds, dists,
        tile, npass, pkind, pstart, st);
  }
  return static_cast<int>(err);
}
