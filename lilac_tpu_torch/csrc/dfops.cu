// The df64 vector algebra of the solvers (solvers/algebra.py:DF64Alg's
// add, sub, smul, sdiv and ssqrt) at one launch a call. Replaces no TPU
// kernel: the JAX package leaves ops/dfloat.py's chains to XLA, which fuses
// them; run eagerly they are one torch launch an EFT step, 20 to 118
// launches a call, so the host, not the card, set their pace.
//
// What it computes, exactly. Element i of the result is the chain's on
// element i of the operands, an operand of step 0 (a 0-dim df scalar)
// giving its one value to every i, as torch broadcasts it:
//   add   df.add(a, b)
//   sub   df.add(a, df.neg(b))                          (df.sub)
//   mul   df.mul(a, b)
//   div   df.div(a, b), then DF64Alg.sdiv's guard: (a.hi, a.hi) where
//         a.hi == 0, so a zero numerator gives that zero, not 0/0 = NaN
//   sqrt  df.sqrt(a)
// Every step is the chain's, in the chain's order, each correctly rounded
// (csrc/df_eft.cuh): the result is the chain's bit for bit. A from_f32
// value's lo word is +0, as torch.zeros_like makes it, and enters the
// steps that follow as the chain has it.
//
// Bound: bytes. 16 n bytes read (four f32 planes; 8 n for sqrt) and 8 n
// written, against 20 to 150 f32 operations an element; at NPB class C
// (n = 150 000) the 3.6 MB are L2's and the launch's own latency exceeds
// the bound. A grid-stride loop over at most kBlocksPerSM thread blocks an
// SM; a 0-dim call is one thread.

#include <cuda_runtime.h>

#include "df_eft.cuh"

namespace {

constexpr int kThreads = 256;     // a thread block
constexpr int kBlocksPerSM = 8;   // thread blocks an SM, at most

enum Op { kAdd = 0, kSub = 1, kMul = 2, kDiv = 3, kSqrt = 4 };

struct Operand {
  const float* hi;
  const float* lo;
  long long step;  // 1: a vector; 0: a 0-dim scalar broadcast over i
  __device__ __forceinline__ df at(long long i) const {
    const long long j = i * step;
    return {hi[j], lo[j]};
  }
};

__device__ __forceinline__ df df_neg(df a) { return {-a.hi, -a.lo}; }

// df.mul_f32(b, q)
__device__ __forceinline__ df df_mul_f32(df b, float q) {
  float p, e;
  two_prod(b.hi, q, p, e);
  e = __fadd_rn(e, __fmul_rn(b.lo, q));
  df r;
  quick_two_sum(p, e, r.hi, r.lo);
  return r;
}

// df.div, three quotient digits
__device__ __forceinline__ df df_div(df a, df b) {
  const float q1 = __fdiv_rn(a.hi, b.hi);
  df r = df_add(a, df_neg(df_mul_f32(b, q1)));
  const float q2 = __fdiv_rn(r.hi, b.hi);
  r = df_add(r, df_neg(df_mul_f32(b, q2)));
  const float q3 = __fdiv_rn(r.hi, b.hi);
  df q;
  quick_two_sum(q1, q2, q.hi, q.lo);
  return df_add(q, {q3, 0.0f});
}

// df.sqrt: one Newton step in df from the f32 root
__device__ __forceinline__ df df_sqrt(df a) {
  const float s = __fsqrt_rn(a.hi);
  const df d = df_add(a, df_neg(df_mul(s, 0.0f, s, 0.0f)));
  const float corr = __fdiv_rn(d.hi, __fmul_rn(2.0f, s));
  return df_add({s, 0.0f}, {corr, 0.0f});
}

template <int O>
__device__ __forceinline__ df apply(const Operand& a, const Operand& b,
                                    long long i) {
  const df x = a.at(i);
  if (O == kSqrt) return df_sqrt(x);
  const df y = b.at(i);
  if (O == kAdd) return df_add(x, y);
  if (O == kSub) return df_add(x, df_neg(y));
  if (O == kMul) return df_mul(x.hi, x.lo, y.hi, y.lo);
  if (x.hi == 0.0f) return {x.hi, x.hi};  // kDiv: DF64Alg.sdiv's guard
  return df_div(x, y);
}

template <int O>
__global__ void __launch_bounds__(kThreads)
    dfops_kernel(Operand a, Operand b, float* __restrict__ hi,
                 float* __restrict__ lo, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const df r = apply<O>(a, b, i);
    hi[i] = r.hi;
    lo[i] = r.lo;
  }
}

}  // namespace

// out = op(a, b) over n elements, op one of Op (b unread for kSqrt), into
// the f32 planes hi and lo (n floats each); an operand plane pair is n
// contiguous floats (step 1) or one value (step 0). On a card of sms SMs,
// on the given stream, one launch.
extern "C" int lilac_dfops(int op, const float* ah, const float* al,
                           long long sa, const float* bh, const float* bl,
                           long long sb, float* hi, float* lo, long long n,
                           int sms, void* stream) {
  if (n < 1 || sms < 1 || (sa != 0 && sa != 1) || (sb != 0 && sb != 1) ||
      ah == nullptr || al == nullptr || hi == nullptr || lo == nullptr ||
      (op != kSqrt && (bh == nullptr || bl == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Operand a = {ah, al, sa};
  const Operand b = {op == kSqrt ? ah : bh, op == kSqrt ? al : bl,
                     op == kSqrt ? sa : sb};
  const long long blocks = (n + kThreads - 1) / kThreads;
  const long long most = static_cast<long long>(sms) * kBlocksPerSM;
  const unsigned grid = static_cast<unsigned>(blocks < most ? blocks : most);
  const unsigned threads = static_cast<unsigned>(n < kThreads ? n : kThreads);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kAdd:
      dfops_kernel<kAdd><<<grid, threads, 0, cs>>>(a, b, hi, lo, n);
      break;
    case kSub:
      dfops_kernel<kSub><<<grid, threads, 0, cs>>>(a, b, hi, lo, n);
      break;
    case kMul:
      dfops_kernel<kMul><<<grid, threads, 0, cs>>>(a, b, hi, lo, n);
      break;
    case kDiv:
      dfops_kernel<kDiv><<<grid, threads, 0, cs>>>(a, b, hi, lo, n);
      break;
    case kSqrt:
      dfops_kernel<kSqrt><<<grid, threads, 0, cs>>>(a, b, hi, lo, n);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
