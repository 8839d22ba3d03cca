// The df64 transpose product's glue around the reverse network
// (kernels/routed_spmv.py: routed_spmv_adj_t_df, routed_hier_spmv_adj_t_df)
// at one launch each. Replaces no TPU kernel: the JAX package leaves the
// adjoint's df.mul and df.sum_df0 chains to XLA, which fuses them; run
// eagerly they are one torch launch an EFT step over every slot of a group
// of nets, and their intermediates went through device memory.
//
// What it computes, exactly.
//   slots_mul  the adjoint of K2's row sums, then the TwoProd by the
//              slot-ordered values: slot s of the output is
//              df.mul(v[s], u[row(s)]) where K2's chunk table (the same
//              table, kernels/dfmulred.py:ChunkTable) puts term k of row r
//              at s = v0 + k * R + r, and df.mul(v[s], +0) at every slot no
//              chunk covers (gaps and pads): the eager chain zero-fills its
//              slot planes, copies each row's cotangent over its terms and
//              multiplies every slot.
//   netsum     df.sum_df0 over the leading (net) axis of [k, m] planes: the
//              halving tree that adds row i + half into row i, a row of +0
//              appended where k is odd, until one row is left; with an
//              accumulator, df.add(acc, that row). Each thread holds one
//              column's tree in registers, up to kMaxNets rows; beyond that
//              the tree's first levels run one launch each (netsum_level),
//              the same pairs in the same order.
// Every step is the chain's, in the chain's order, each correctly rounded
// (csrc/df_eft.cuh), so the outputs are the chain's bit for bit.
//
// Bound: bytes. slots_mul reads the values (8 bytes a slot) and writes the
// product (8 bytes); the cotangents are read once a row. netsum reads k
// planes of 8 bytes a column and writes one. At NPB class D (16 nets,
// m = 2^21) that is 0.54 GB and 0.27 GB a group.

#include <cuda_runtime.h>

#include <utility>

#include "df_eft.cuh"

namespace {

constexpr int kThreads = 256;    // a thread block
constexpr int kBlocksPerSM = 8;  // netsum's thread blocks an SM, at most
constexpr int kMaxNets = 32;     // rows netsum sums in registers

// A row of slots_mul's block list: K2's RowBlock (n rows of one chunk, the
// first at slot v0, term stride R, row cotangent y0; kn = K << 32 | n), or,
// where y0 < 0, a gap piece: kn slots from slot v0 that no chunk covers.
struct Block {
  long long v0, y0, R, kn;
};

template <int VS>
__device__ __forceinline__ df load_v(const float* __restrict__ vh,
                                     const float* __restrict__ vl,
                                     long long s) {
  if (VS == 2) {  // the (hi, lo) pairs of an interleaved [.., 2] array
    const float2 p = reinterpret_cast<const float2*>(vh)[s];
    return {p.x, p.y};
  }
  return {vh[s], vl[s]};
}

template <int VS>
__global__ void __launch_bounds__(kThreads)
    slots_mul_kernel(const float* __restrict__ vh, const float* __restrict__ vl,
                     const float* __restrict__ uh, const float* __restrict__ ul,
                     float* __restrict__ oh, float* __restrict__ ol,
                     const Block* __restrict__ blocks) {
  const longlong2 a = reinterpret_cast<const longlong2*>(blocks + blockIdx.x)[0];
  const longlong2 b = reinterpret_cast<const longlong2*>(blocks + blockIdx.x)[1];
  const long long v0 = a.x, y0 = a.y, R = b.x;
  if (y0 < 0) {  // a gap: the value times the zero-filled slot
    for (long long i = threadIdx.x; i < b.y; i += blockDim.x) {
      const df v = load_v<VS>(vh, vl, v0 + i);
      const df p = df_mul(v.hi, v.lo, 0.0f, 0.0f);
      oh[v0 + i] = p.hi;
      ol[v0 + i] = p.lo;
    }
    return;
  }
  const int K = static_cast<int>(b.y >> 32);
  const int n = static_cast<int>(b.y & 0xffffffffLL);
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    const float u_h = uh[y0 + r], u_l = ul[y0 + r];
    long long s = v0 + r;
    for (int k = 0; k < K; ++k, s += R) {
      const df v = load_v<VS>(vh, vl, s);
      const df p = df_mul(v.hi, v.lo, u_h, u_l);
      oh[s] = p.hi;
      ol[s] = p.lo;
    }
  }
}

// One level of df.sum_df0's tree over k rows: row i + half into row i
// (half = (k + 1) / 2), the last row alone plus +0 where k is odd.
template <int K>
__device__ __forceinline__ void tree(df* x) {
  if constexpr (K > 1) {
    constexpr int H = (K + 1) / 2;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      x[i] = df_add(x[i], i + H < K ? x[i + H] : df{0.0f, 0.0f});
    }
    tree<H>(x);
  }
}

// y[j] = the tree over the K rows of column j (x row i at x + i * m), then
// df.add(acc[j], it) where acc is given.
template <int K>
__global__ void __launch_bounds__(kThreads)
    netsum_kernel(const float* __restrict__ xh, const float* __restrict__ xl,
                  long long m, const float* __restrict__ ah,
                  const float* __restrict__ al, float* __restrict__ yh,
                  float* __restrict__ yl) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < m; j += stride) {
    df x[K];
#pragma unroll
    for (int i = 0; i < K; ++i) x[i] = {xh[i * m + j], xl[i * m + j]};
    tree<K>(x);
    df r = x[0];
    if (ah != nullptr) r = df_add({ah[j], al[j]}, r);
    yh[j] = r.hi;
    yl[j] = r.lo;
  }
}

// One level of the tree over k rows of m columns into half rows.
__global__ void __launch_bounds__(kThreads)
    netsum_level_kernel(const float* __restrict__ xh,
                        const float* __restrict__ xl, long long k, long long m,
                        float* __restrict__ yh, float* __restrict__ yl) {
  const long long half = (k + 1) / 2;
  const long long total = half * m;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const long long i = t / m;
    const df x = {xh[t], xl[t]};
    const df w = i + half < k ? df{xh[t + half * m], xl[t + half * m]}
                              : df{0.0f, 0.0f};
    const df r = df_add(x, w);
    yh[t] = r.hi;
    yl[t] = r.lo;
  }
}

unsigned grid_for(long long work, int sms) {
  const long long blocks = (work + kThreads - 1) / kThreads;
  const long long most = static_cast<long long>(sms) * kBlocksPerSM;
  return static_cast<unsigned>(blocks < most ? blocks : most);
}

template <int K>
void launch_netsum(const float* xh, const float* xl, long long m,
                   const float* ah, const float* al, float* yh, float* yl,
                   unsigned grid, cudaStream_t cs) {
  netsum_kernel<K><<<grid, kThreads, 0, cs>>>(xh, xl, m, ah, al, yh, yl);
}

template <int... Ks>
bool dispatch_netsum(long long k, const float* xh, const float* xl,
                     long long m, const float* ah, const float* al, float* yh,
                     float* yl, unsigned grid, cudaStream_t cs,
                     std::integer_sequence<int, Ks...>) {
  // K = Ks + 1 for Ks = 0 .. kMaxNets - 1
  return ((k == Ks + 1 ? (launch_netsum<Ks + 1>(xh, xl, m, ah, al, yh, yl, grid, cs),
                          true)
                       : false) || ...);
}

}  // namespace

// The slots of nblocks blocks (Block rows, int64): values v (vh / vl with
// element stride vstride, 1 or 2; for 2 the pairs of an interleaved array
// at vh), row cotangents uh / ul, products into oh / ol. One launch.
extern "C" int lilac_dfadj_slots_mul(const float* vh, const float* vl,
                                     long long vstride, const float* uh,
                                     const float* ul, float* oh, float* ol,
                                     const long long* blocks, long long nblocks,
                                     void* stream) {
  if (nblocks < 1 || nblocks > 0x7fffffffLL || (vstride != 1 && vstride != 2) ||
      vh == nullptr || vl == nullptr || uh == nullptr || ul == nullptr ||
      oh == nullptr || ol == nullptr || blocks == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Block* bl = reinterpret_cast<const Block*>(blocks);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(nblocks);
  if (vstride == 2) {
    slots_mul_kernel<2><<<grid, kThreads, 0, cs>>>(vh, vl, uh, ul, oh, ol, bl);
  } else {
    slots_mul_kernel<1><<<grid, kThreads, 0, cs>>>(vh, vl, uh, ul, oh, ol, bl);
  }
  return static_cast<int>(cudaGetLastError());
}

// y = the tree over k <= kMaxNets rows of m columns (row i at xh + i * m),
// then df.add(acc, y) where ah / al are given (null: no accumulator). On a
// card of sms SMs, one launch.
extern "C" int lilac_dfadj_netsum(const float* xh, const float* xl, long long k,
                                  long long m, const float* ah, const float* al,
                                  float* yh, float* yl, int sms, void* stream) {
  if (k < 1 || k > kMaxNets || m < 1 || sms < 1 || xh == nullptr ||
      xl == nullptr || yh == nullptr || yl == nullptr ||
      (ah == nullptr) != (al == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  dispatch_netsum(k, xh, xl, m, ah, al, yh, yl, grid_for(m, sms), cs,
                  std::make_integer_sequence<int, kMaxNets>{});
  return static_cast<int>(cudaGetLastError());
}

// One level of the tree: k rows of m columns into (k + 1) / 2 rows.
extern "C" int lilac_dfadj_netsum_level(const float* xh, const float* xl,
                                        long long k, long long m, float* yh,
                                        float* yl, int sms, void* stream) {
  if (k < 2 || m < 1 || sms < 1 || xh == nullptr || xl == nullptr ||
      yh == nullptr || yl == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  netsum_level_kernel<<<grid_for((k + 1) / 2 * m, sms), kThreads, 0, cs>>>(
      xh, xl, k, m, yh, yl);
  return static_cast<int>(cudaGetLastError());
}
