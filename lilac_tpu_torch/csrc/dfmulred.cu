// K2: dfmulred for Hopper (sm_90a). Replaces the Pallas kernel
// lilac_tpu/kernels/dfmulred.py:_kern / _dfmulred_call / dfmulred.
//
// Computes y[r] = sum_k df(v)[k, r] * df(x)[k, r] over column-major [K, R]
// planes of (hi, lo) f32 pairs, by Ogita-Rump-Oishi dot2: TwoProd per
// term, TwoSum into the high accumulator, first-order terms compensated in
// a running low part; the output is the (hi, lo) pair of TwoSum(s, c).
//
// Design. One thread per output row r and a run-time loop over K: with the
// [K, R] layout neighbouring threads read neighbouring addresses, so every
// load is coalesced and nothing is staged in shared memory. The v planes
// may be given with an element stride of 2, which reads the (hi, lo) pairs
// of an interleaved [.., 2] value array in place.
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

namespace {

__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

__device__ __forceinline__ void split(float a, float& hi, float& lo) {
  const float t = __fmul_rn(4097.0f, a);  // 2^12 + 1
  hi = __fsub_rn(t, __fsub_rn(t, a));
  lo = __fsub_rn(a, hi);
}

// Dekker TwoProd, the same sequence as the plain version so that the two
// agree bit for bit. (__fmaf_rn(a, b, -p) gives the same error term in one
// instruction; the kernel is bound by bytes, so the longer form costs
// nothing.)
__device__ __forceinline__ void two_prod(float a, float b, float& p, float& e) {
  p = __fmul_rn(a, b);
  float ahi, alo, bhi, blo;
  split(a, ahi, alo);
  split(b, bhi, blo);
  e = __fsub_rn(__fmul_rn(ahi, bhi), p);
  e = __fadd_rn(e, __fmul_rn(ahi, blo));
  e = __fadd_rn(e, __fmul_rn(alo, bhi));
  e = __fadd_rn(e, __fmul_rn(alo, blo));
}

__global__ void dfmulred_kernel(const float* __restrict__ vh,
                                const float* __restrict__ vl,
                                long long vstride,
                                const float* __restrict__ xh,
                                const float* __restrict__ xl,
                                float* __restrict__ yh,
                                float* __restrict__ yl, int K, long long R) {
  const long long r =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= R) return;
  float s = 0.0f, c = 0.0f;
  for (int k = 0; k < K; ++k) {
    const long long i = static_cast<long long>(k) * R + r;
    const float a_h = vh[i * vstride];
    const float a_l = vl[i * vstride];
    const float b_h = xh[i];
    const float b_l = xl[i];
    float p, ep, es;
    two_prod(a_h, b_h, p, ep);
    // first-order cross terms of the df x df product
    ep = __fadd_rn(ep, __fadd_rn(__fmul_rn(a_h, b_l), __fmul_rn(a_l, b_h)));
    two_sum(s, p, s, es);
    c = __fadd_rn(c, __fadd_rn(es, ep));
  }
  float hi, lo;
  two_sum(s, c, hi, lo);
  yh[r] = hi;
  yl[r] = lo;
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

}  // namespace

// v element (k, r) is at vh[(k*R + r) * vstride]; x and y are contiguous.
extern "C" int lilac_dfmulred(const float* vh, const float* vl,
                              long long vstride, const float* xh,
                              const float* xl, float* yh, float* yl, int K,
                              long long R, void* stream) {
  if (K < 0 || R < 0 || vstride < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (R == 0) return static_cast<int>(cudaSuccess);
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((R + threads - 1) / threads);
  dfmulred_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      vh, vl, vstride, xh, xl, yh, yl, K, R);
  return static_cast<int>(cudaGetLastError());
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
