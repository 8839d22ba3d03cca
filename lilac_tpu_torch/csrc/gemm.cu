// K12: matmul_nt for Hopper (sm_90a). Replaces the Pallas kernel
// lilac_tpu/kernels/pallas_gemm.py:_kernel / matmul_nt (the pl.pallas_call
// at :46), Parboil sgemm's product.
//
// Computes C = A * Bt^T with A [M, K], Bt [N, K] and C [M, N], all float32
// and row-major (Parboil's "NT" layout: both operands K-contiguous).
//
// Design. One thread block of 256 threads per 128 x 128 tile of C; each
// thread holds an 8 x 8 sub-tile of f32 accumulators in registers, the
// rows {4ty..4ty+3, 64+4ty..64+4ty+3} and the columns likewise from tx, so
// that a quarter-warp's 16-byte shared-memory reads are contiguous. The K
// axis runs as a loop inside the block (the TPU kernel's sequential grid
// dimension): slices of BK = 8 columns of A and Bt are staged in shared
// memory TRANSPOSED, [BK][128] (M- and N-contiguous), so the inner product
// reads two float4 of A and two of Bt per k for 64 FMAs. Two staging
// buffers and a register prefetch of the next slice: one barrier a slice.
// The rows of a staged slice are padded to 132 words, which keeps the
// transposing stores free of bank conflicts.
//
// Ragged edges. Loads past M, N or K read zeros and stores past M or N
// are skipped, so any shape runs without a padded host copy. Global loads
// are float4 when K % 4 == 0 and both operands are 16-byte aligned (the
// wrapper decides), else four guarded scalar loads; C is stored as float4
// where N % 4 == 0 and the four columns are inside.
//
// Bound: operations at large sizes (2*M*N*K f32 FMA work against
// 4*(MK + NK + MN) bytes: at 4096^3 about 680 flops a byte).
//
// Arithmetic. f32 products with f32 accumulation, FFMA on the CUDA cores:
// no tensor cores and no TF32 (TF32 rounds each input to 11 bits, about
// 2^-11 relative per product, which at K = 4096 comes near Parboil's
// 1e-4 * max|C| line). Every source of the port is compiled with
// --fmad=false (the df64 kernels need each step rounded on its own), so a
// written a*b + c would become an FMUL and an FADD: half the rate and
// another rounding. The inner product is therefore spelled with
// __fmaf_rn. Each element is one sequential fused sum over k, within
// K * 2^-24 * sum_k |a_ik b_jk| of the exact product.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 8;
constexpr int THREADS = 256;
constexpr int LDS = BM + 4;  // padded row of a staged slice

// Four consecutive k of one row of a row-major [R, K] operand:
// row r0 + tid / 2, columns k0 + (tid % 2) * 4 .. + 3; zeros outside.
template <bool VEC>
__device__ __forceinline__ void load_slice(const float* __restrict__ src,
                                           int R, int K, int r0, int k0,
                                           float (&v)[4]) {
  const int row = r0 + (threadIdx.x >> 1);
  const int k = k0 + ((threadIdx.x & 1) << 2);
  if (VEC) {
    // K % 4 == 0: k < K implies k + 3 < K
    if (row < R && k < K) {
      const float4 t = *reinterpret_cast<const float4*>(
          src + static_cast<long long>(row) * K + k);
      v[0] = t.x;
      v[1] = t.y;
      v[2] = t.z;
      v[3] = t.w;
    } else {
      v[0] = v[1] = v[2] = v[3] = 0.0f;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = (row < R && k + j < K)
                 ? src[static_cast<long long>(row) * K + k + j]
                 : 0.0f;
    }
  }
}

// The loaded words, transposed into a [BK][LDS] staging buffer.
__device__ __forceinline__ void store_slice(float (*s)[LDS],
                                            const float (&v)[4]) {
  const int row = threadIdx.x >> 1;
  const int kq = (threadIdx.x & 1) << 2;
#pragma unroll
  for (int j = 0; j < 4; ++j) s[kq + j][row] = v[j];
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
    matmul_nt_kernel(const float* __restrict__ a,
                     const float* __restrict__ bt, float* __restrict__ c,
                     int M, int N, int K, int vec_c) {
  __shared__ __align__(16) float As[2][BK][LDS];
  __shared__ __align__(16) float Bs[2][BK][LDS];

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }

  float ra[4], rb[4];
  load_slice<VEC>(a, M, K, m0, 0, ra);
  load_slice<VEC>(bt, N, K, n0, 0, rb);
  store_slice(As[0], ra);
  store_slice(Bs[0], rb);
  __syncthreads();

  const int nk = (K + BK - 1) / BK;
  for (int t = 0; t < nk; ++t) {
    const int cur = t & 1;
    const bool more = t + 1 < nk;
    if (more) {  // the next slice travels while this one is multiplied
      load_slice<VEC>(a, M, K, m0, (t + 1) * BK, ra);
      load_slice<VEC>(bt, N, K, n0, (t + 1) * BK, rb);
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][kk][4 * ty]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[cur][kk][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][kk][4 * tx]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[cur][kk][64 + 4 * tx]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
        }
      }
    }
    if (more) {  // the other buffer: last read before the previous barrier
      store_slice(As[cur ^ 1], ra);
      store_slice(Bs[cur ^ 1], rb);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + (i - 4));
    if (row >= M) continue;
    float* crow = c + static_cast<long long>(row) * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + 64 * h + 4 * tx;
      if (vec_c && col + 3 < N) {
        *reinterpret_cast<float4*>(crow + col) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (col + j < N) crow[col + j] = acc[i][4 * h + j];
        }
      }
    }
  }
}

}  // namespace

// C [M, N] = A [M, K] * Bt [N, K]^T, all row-major float32. vec != 0: K % 4
// == 0 and a, bt 16-byte aligned (float4 loads). C must be 16-byte aligned.
extern "C" int lilac_matmul_nt(const float* a, const float* bt, float* c,
                               int M, int N, int K, int vec, void* stream) {
  if (M < 0 || N < 0 || K < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M == 0 || N == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const int vec_c = (N % 4) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    matmul_nt_kernel<true><<<grid, THREADS, 0, s>>>(a, bt, c, M, N, K, vec_c);
  } else {
    matmul_nt_kernel<false><<<grid, THREADS, 0, s>>>(a, bt, c, M, N, K, vec_c);
  }
  return static_cast<int>(cudaGetLastError());
}
