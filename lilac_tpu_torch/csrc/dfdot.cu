// The df64 dot product of the solvers (solvers/algebra.py:DF64Alg.dot) as
// two launches. Replaces no TPU kernel: the JAX package leaves
// ops/dfloat.py:dot (df.mul, then the pairwise halving tree of sum_df) to
// XLA, which fuses the chain; run eagerly it is about 400 kernel launches a
// dot at na = 150 000, so the host, not the card, set its pace.
//
// What it computes, exactly. The halving tree of sum_df is memoryless:
// with level sizes n_0 = n and n_{k+1} = ceil(n_k / 2), level k + 1 holds,
// for i < n_{k+1},
//     L_{k+1}[i] = add(L_k[i], i + n_{k+1} < n_k ? L_k[i + n_{k+1}] : 0),
// where L_0[j] = mul(a[j], b[j]) and 0 is the df zero (a pad of F.pad is
// added, not skipped, which keeps signed zeros). So a thread computes
// L_K[i] alone: it walks the 2^K leaves of its subtree, i plus sums of the
// level sizes, merging them on a stack of K df values in the tree's own
// order. The first launch does that for every i < n_K (one warp a thread
// block, so that n_K threads spread over the SMs); the second launch, one
// thread block, takes the n_K values through the same walk to at most
// kLastThreads values, then halves them in shared memory down to one.
// Every add and mul is df.add / df.mul operation for operation, so the
// result is df.dot's, bit for bit. Neighbouring threads read neighbouring
// leaves (the same offset from i), so every load is coalesced.
//
// Bound: bytes. 16 n bytes read once (four f32 planes) against about 50 f32
// operations a term; at n = 150 000 the planes fit in the 50 MB L2, and the
// two launches' own latency exceeds the bound.
//
// Exact rounding: the error-free transformations and df_add / df_mul are
// csrc/df_eft.cuh's, every step an __f*_rn intrinsic under --fmad=false.

#include <cuda_runtime.h>
#include <stdint.h>

#include "df_eft.cuh"

namespace {

constexpr int kMaxDepth = 16;       // leaves a thread of the first launch: 2^16
constexpr int kFillDepth = 5;       // at most 32 leaves a thread where the SMs are full
constexpr int kLastDepth = 8;       // of the second (1024 threads: 64 registers each)
constexpr int kFirstThreads = 32;   // a thread block of the first launch
constexpr int kLastThreads = 1024;  // the second launch's one thread block
constexpr long long kLastMax = 1ll << 16;  // values the second launch takes
constexpr int kBatch = 4;           // leaves whose loads are in flight together

// ceil(m / 2^k): the size of level k of a tree over m values
__device__ __host__ __forceinline__ long long level(long long m, int k) {
  return ((m - 1) >> k) + 1;
}

// Leaves of the whole tree: term j is mul(a[j], b[j]) of four planes.
struct Planes {
  const float* ah;
  const float* al;
  const float* bh;
  const float* bl;
  using Raw = float4;
  __device__ __forceinline__ Raw load(long long j) const {
    return make_float4(ah[j], al[j], bh[j], bl[j]);
  }
  __device__ __forceinline__ df value(Raw r) const {
    return df_mul(r.x, r.y, r.z, r.w);
  }
};

// Leaves of the tree's upper levels: the first launch's (hi, lo) pairs.
struct Pairs {
  const float2* v;
  using Raw = float2;
  __device__ __forceinline__ Raw load(long long j) const { return v[j]; }
  __device__ __forceinline__ df value(Raw r) const { return {r.x, r.y}; }
};

// Leaf t's value enters the stack: while bit k of t is set, the value
// completes the right half of a level-(k + 1) node, whose left half waits
// in st[k]. Unrolled, so every st[k] is a register.
template <int MaxDepth>
__device__ __forceinline__ void push(df (&st)[MaxDepth], df& v, int t) {
#pragma unroll
  for (int k = 0; k < MaxDepth; ++k) {
    if (!((t >> k) & 1)) {
      st[k] = v;
      return;
    }
    v = df_add(st[k], v);
  }
}

// L_depth[i] of the tree over the m values that src holds (i < level(m,
// depth)): the 2^depth leaves in the tree's order, a leaf whose path takes
// a pad being the df zero; depth <= MaxDepth.
template <int MaxDepth, class Src>
__device__ __forceinline__ df subtree(const Src& src, long long i, long long m,
                                      int depth) {
  df st[MaxDepth];
  df v = {0.0f, 0.0f};
  const int leaves = 1 << depth;
  for (int t0 = 0; t0 < leaves; t0 += kBatch) {
    typename Src::Raw raw[kBatch];
    bool in[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int t = t0 + b;
      long long j = i;
      bool ok = t < leaves;
      for (int k = depth; k >= 1; --k) {
        if ((t >> (k - 1)) & 1) {  // the right child at level k
          j += level(m, k);
          ok = ok && j < level(m, k - 1);
        }
      }
      in[b] = ok;
      raw[b] = ok ? src.load(j) : typename Src::Raw{};
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (t0 + b < leaves) {
        v = in[b] ? src.value(raw[b]) : df{0.0f, 0.0f};
        push<MaxDepth>(st, v, t0 + b);
      }
    }
  }
  return v;
}

__global__ void __launch_bounds__(kFirstThreads)
    dfdot_first_kernel(Planes src, long long n, int depth,
                       float2* __restrict__ part) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kFirstThreads + threadIdx.x;
  if (i >= level(n, depth)) return;
  const df v = subtree<kMaxDepth>(src, i, n, depth);
  part[i] = make_float2(v.hi, v.lo);
}

// The m values of src down to one, into out[0] (hi) and out[1] (lo).
template <class Src>
__global__ void __launch_bounds__(kLastThreads)
    dfdot_last_kernel(Src src, long long m, int depth, float* __restrict__ out) {
  __shared__ float2 sh[kLastThreads];
  const int i = threadIdx.x;
  int s = static_cast<int>(level(m, depth));
  if (i < s) {
    const df v = subtree<kLastDepth>(src, i, m, depth);
    sh[i] = make_float2(v.hi, v.lo);
  }
  __syncthreads();
  while (s > 1) {
    // thread i reads sh[i] and sh[i + h] and writes sh[i]: no other
    // thread reads sh[i] in this level, so one barrier a level
    const int h = (s + 1) / 2;
    if (i < h) {
      const float2 a = sh[i];
      const float2 b = i + h < s ? sh[i + h] : make_float2(0.0f, 0.0f);
      const df r = df_add({a.x, a.y}, {b.x, b.y});
      sh[i] = make_float2(r.hi, r.lo);
    }
    __syncthreads();
    s = h;
  }
  if (i == 0) {
    out[0] = sh[0].x;
    out[1] = sh[0].y;
  }
}

// fewest levels that take m values to at most kLastThreads
int last_depth(long long m) {
  int d = 0;
  while (level(m, d) > kLastThreads) ++d;
  return d;
}

}  // namespace

// The levels of the tree over n terms that the first launch takes, from n
// and the card's SM count alone: the most, up to kFillDepth, that leave a
// thread block on every SM; more only where the second launch would
// otherwise take over kLastMax values. 0 (the second launch alone) below a
// warp an SM; -1 where n or sms is below 1 or n exceeds 2^32.
extern "C" int lilac_dfdot_depth(long long n, int sms) {
  if (n < 1 || sms < 1) return -1;
  int k = 0;
  while (k < kFillDepth &&
         level(n, k + 1) >= static_cast<long long>(sms) * kFirstThreads) {
    ++k;
  }
  while (level(n, k) > kLastMax) ++k;
  return k <= kMaxDepth ? k : -1;
}

// dot(a, b) of n-long df planes (ah, al) and (bh, bl), contiguous f32, into
// out[0] (hi) and out[1] (lo), on a card of sms SMs. part: 2 * level(n,
// lilac_dfdot_depth(n, sms)) floats of scratch, 8-byte aligned, unused (and
// may be null) where that depth is 0 and the second launch reads the planes.
extern "C" int lilac_dfdot(const float* ah, const float* al, const float* bh,
                           const float* bl, long long n, int sms, float* part,
                           float* out, void* stream) {
  const int depth = lilac_dfdot_depth(n, sms);
  if (depth < 0 || out == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long m = level(n, depth);
  // at most kLastMax values leave the second launch at most kLastDepth levels
  static_assert(kLastMax <= static_cast<long long>(kLastThreads) << kLastDepth, "");
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const Planes planes = {ah, al, bh, bl};
  if (depth == 0) {
    dfdot_last_kernel<Planes><<<1, kLastThreads, 0, cs>>>(planes, n,
                                                          last_depth(n), out);
    return static_cast<int>(cudaGetLastError());
  }
  if (part == nullptr || reinterpret_cast<uintptr_t>(part) % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float2* pairs = reinterpret_cast<float2*>(part);
  const unsigned grid =
      static_cast<unsigned>((m + kFirstThreads - 1) / kFirstThreads);
  dfdot_first_kernel<<<grid, kFirstThreads, 0, cs>>>(planes, n, depth, pairs);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const Pairs upper = {pairs};
  dfdot_last_kernel<Pairs><<<1, kLastThreads, 0, cs>>>(upper, m, last_depth(m),
                                                       out);
  return static_cast<int>(cudaGetLastError());
}
