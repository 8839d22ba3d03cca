// The inner pass of a hierarchical gather network (K3, K3u and, with REV,
// K7) for Hopper (sm_90a), included by hier.cu. It replaces the Pallas
// kernels routed_apply_sliced_b / routed_apply_sliced / routed_apply_sliced_bt
// of lilac_tpu/kernels/routed.py.
//
// What it computes: logical block b of bl slots (read at physical block
// phys(b) of each net's plane, or of one plane all nets share) runs S <= 64
// xor stages y[i] <- m_s[i] ? y[i ^ d_s] : y[i], in order (REV: last stage
// first; an exchange is its own adjoint), and is written in natural block
// order. The stage's switch for slot i is bit s % 8 of plane s / 8 of the
// block's mask bytes [P, bl]. Words are only moved, so the result is bit for
// bit the plain version's whatever the values are.
//
// Bound: bytes (each slot's words and mask bytes read once, its words
// written once). What held the first design back was shared memory: every
// stage read and wrote the whole block there, 25 round trips for one of
// device memory. Here the stages run in REGISTERS:
//   * a slot index of L = log2(bl) bits is split into rb register bits
//     (2^rb slots a thread), 5 lane bits and L - rb - 5 warp bits;
//   * a stage on a register bit is a select between two registers of a
//     thread, a stage on a lane bit one __shfl_xor_sync per 32-bit word; each
//     thread reads its own slots' switches, so no mask value travels;
//   * a stage on a warp bit never runs in place: the host cuts the pass into
//     RUNS of consecutive stages whose distance bits are register or lane
//     bits of one assignment (kernels/routed.py:inner_runs), and between two
//     runs the block goes once through shared memory (the 25-stage Benes pass
//     at bl = 2^13 is 3 runs);
//   * the block enters and leaves shared memory by coalesced 16-byte
//     accesses; there it is stored swizzled, slot i at i ^ g(i >> 5) with
//     every bit j of i folded onto bank bit j % 5, and a run's lane bits have
//     distinct residues mod 5, so each warp access of a run touches 32 banks;
//   * a slot's mask bytes are regrouped on the load into one 32-bit word per
//     32 stages, stored beside the values with the same swizzle: a run's
//     stages (at most 16) lie inside one such word, and a thread keeps their
//     bits for two of its slots in one register;
//   * each thread issues all its loads of a block before it stores any of
//     them to shared memory, so that a block's load has many requests in
//     flight; two blocks share an SM, one loading while the other exchanges.
// A 64-bit word travels as two 32-bit halves (two shared planes, two
// shuffles); a df64 (hi, lo) pair as two planes of 32-bit words.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace inner {

constexpr int kLaneBits = 5;
constexpr int kMinRegBits = 2;
constexpr int kMaxRegBits = 4;
constexpr int kMaxStages = 64;
constexpr int kMaxRuns = 64;
constexpr int kMaxRunStages = 16;
constexpr int kMaxThreads = 1024;

struct Run {
  unsigned char a, b;       // stages [a, b), at most 16, inside one 32-stage mask word
  unsigned char perm[16];   // slot bit carried by bit t of (tid << rb | register)
};

// The schedule of one pass (kernels/routed.py:inner_runs). code[s] is the
// register bit q (q < 8) or the lane bit q - 8 (q >= 8) stage s exchanges
// across, in its run's assignment.
struct Sched {
  int nruns;
  int rb;
  unsigned char code[kMaxStages];
  Run run[kMaxRuns];
};

__device__ __forceinline__ int swz(int i) {
  const int h = i >> 5;
  return i ^ ((h ^ (h >> 5) ^ (h >> 10)) & 31);
}

// element t of q goes to place t ^ g (g < 4)
__device__ __forceinline__ uint4 quad_perm(uint4 q, int g) {
  if (g & 1) {
    uint32_t t = q.x; q.x = q.y; q.y = t;
    t = q.z; q.z = q.w; q.w = t;
  }
  if (g & 2) {
    uint32_t t = q.x; q.x = q.z; q.z = t;
    t = q.y; q.y = q.w; q.w = t;
  }
  return q;
}

// slots i..i+3 (i % 4 == 0) of one shared plane of bl words; the swizzle
// keeps an aligned quad together and only permutes inside it
__device__ __forceinline__ void put_quad(uint32_t* plane, int i, uint4 q) {
  const int s = swz(i);
  *reinterpret_cast<uint4*>(plane + (s & ~3)) = quad_perm(q, (s ^ i) & 3);
}

__device__ __forceinline__ uint4 get_quad(const uint32_t* plane, int i) {
  const int s = swz(i);
  return quad_perm(*reinterpret_cast<const uint4*>(plane + (s & ~3)), (s ^ i) & 3);
}

// x[j] = plane j's bytes of slots i..i+3 -> one word per slot, byte j = plane j
__device__ __forceinline__ uint4 mask_words(uint32_t x0, uint32_t x1,
                                            uint32_t x2, uint32_t x3) {
  const uint32_t lo01 = __byte_perm(x0, x1, 0x5140);
  const uint32_t hi01 = __byte_perm(x0, x1, 0x7362);
  const uint32_t lo23 = __byte_perm(x2, x3, 0x5140);
  const uint32_t hi23 = __byte_perm(x2, x3, 0x7362);
  return make_uint4(__byte_perm(lo01, lo23, 0x5410), __byte_perm(lo01, lo23, 0x7632),
                    __byte_perm(hi01, hi23, 0x5410), __byte_perm(hi01, hi23, 0x7632));
}

// the switch of register k at the run's stage j: bit j of the low half of
// pk[k] for the first NR / 2 registers, of the high half for the others
template <int K, int NR>
__device__ __forceinline__ bool switch_of(const uint32_t (&pk)[NR / 2], int j) {
  return (pk[K % (NR / 2)] >> (j + 16 * (K / (NR / 2)))) & 1u;
}

template <int Q, int NW, int NR, int K = 0>
__device__ __forceinline__ void reg_stage(uint32_t (&v)[NW][NR],
                                          const uint32_t (&pk)[NR / 2], int j) {
  if constexpr ((1 << Q) < NR && K < NR) {
    if constexpr (!(K & (1 << Q))) {
      constexpr int K2 = K | (1 << Q);
      const bool mi = switch_of<K, NR>(pk, j);
      const bool mq = switch_of<K2, NR>(pk, j);
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const uint32_t x = v[w][K];
        const uint32_t y = v[w][K2];
        v[w][K] = mi ? y : x;
        v[w][K2] = mq ? x : y;
      }
    }
    reg_stage<Q, NW, NR, K + 1>(v, pk, j);
  }
}

template <int NW, int NR, int K = 0>
__device__ __forceinline__ void lane_stage(uint32_t (&v)[NW][NR],
                                           const uint32_t (&pk)[NR / 2], int j,
                                           int lm) {
  if constexpr (K < NR) {
    const bool take = switch_of<K, NR>(pk, j);
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const uint32_t o = __shfl_xor_sync(0xffffffffu, v[w][K], lm);
      v[w][K] = take ? o : v[w][K];
    }
    lane_stage<NW, NR, K + 1>(v, pk, j, lm);
  }
}

// Run r of the schedule: the thread's 2^RB slots from shared memory into
// registers, the run's stages, the slots back to the same places. A thread
// writes exactly the slots it read, so a run needs no barrier inside.
template <int NW, int RB, bool REV>
__device__ __forceinline__ void run_stages(uint32_t* sm, int bl, int lbits,
                                           const Sched& sc, int r) {
  constexpr int NR = 1 << RB;
  const Run& run = sc.run[r];
  const int a = run.a;
  const int e = run.b;
  const int tid = threadIdx.x;
  // swz is linear over xor: register k's place is base ^ the steps of k's bits
  int base = 0;
  for (int t = RB; t < lbits; ++t) base |= ((tid >> (t - RB)) & 1) << run.perm[t];
  base = swz(base);
  int step[RB];
#pragma unroll
  for (int q = 0; q < RB; ++q) step[q] = swz(1 << run.perm[q]);
  const uint32_t* mplane = sm + (NW + (a >> 5)) * bl;
  uint32_t v[NW][NR];
  uint32_t pk[NR / 2];
#pragma unroll
  for (int k = 0; k < NR; ++k) {
    int ad = base;
#pragma unroll
    for (int q = 0; q < RB; ++q) {
      if ((k >> q) & 1) ad ^= step[q];
    }
#pragma unroll
    for (int w = 0; w < NW; ++w) v[w][k] = sm[w * bl + ad];
    const uint32_t bits = (mplane[ad] >> (a & 31)) & 0xffffu;
    if (k < NR / 2) {
      pk[k] = bits;
    } else {
      pk[k - NR / 2] |= bits << 16;
    }
  }
  for (int u = 0; u < e - a; ++u) {
    const int s = REV ? e - 1 - u : a + u;
    const int code = sc.code[s];
    const int j = s - a;
    if (code >= 8) {
      lane_stage(v, pk, j, 1 << (code - 8));
    } else if (code == 0) {
      reg_stage<0>(v, pk, j);
    } else if (code == 1) {
      reg_stage<1>(v, pk, j);
    } else if (code == 2) {
      reg_stage<2>(v, pk, j);
    } else {
      reg_stage<3>(v, pk, j);
    }
  }
#pragma unroll
  for (int k = 0; k < NR; ++k) {
    int ad = base;
#pragma unroll
    for (int q = 0; q < RB; ++q) {
      if ((k >> q) & 1) ad ^= step[q];
    }
#pragma unroll
    for (int w = 0; w < NW; ++w) sm[w * bl + ad] = v[w][k];
  }
}

struct BlockLayout {
  int nbits;
  unsigned char src[32];  // physical block bit k <- logical bit src[k]
};

__device__ __forceinline__ long long phys_of(long long b, const BlockLayout& l) {
  long long out = 0;
  for (int k = 0; k < l.nbits; ++k) out |= ((b >> l.src[k]) & 1ll) << k;
  return out;
}

// grid (nblocks, N), bl >> RB threads. Value planes as 32-bit words (ES / 4
// of them a slot), sstride in slots between nets (0: one shared plane).
// masks [N, nblocks, P, bl] bytes. Shared memory: NW + ceil(P / 4) planes of
// bl words.
template <int ES, int NP, int RB, bool REV>
__global__ void __launch_bounds__(kMaxThreads)
kernel(const uint32_t* __restrict__ s0, const uint32_t* __restrict__ s1,
       long long sstride, uint32_t* __restrict__ d0, uint32_t* __restrict__ d1,
       long long m, int bl, int lbits, const uint8_t* __restrict__ masks, int P,
       const __grid_constant__ Sched sc, const __grid_constant__ BlockLayout lay) {
  constexpr int WPS = ES / 4;
  constexpr int NW = NP * WPS;
  constexpr int NR = 1 << RB;
  extern __shared__ __align__(16) uint32_t sm[];
  const int nm = (P + 3) >> 2;
  const long long b = blockIdx.x;
  const long long n = blockIdx.y;
  const long long nblocks = gridDim.x;
  const long long src_off = (n * sstride + phys_of(b, lay) * bl) * WPS;
  const long long dst_off = (n * m + b * bl) * WPS;
  const uint32_t* srcs[2] = {s0, s1};
  uint32_t* dsts[2] = {d0, d1};
  const uint8_t* mbase = masks + (n * nblocks + b) * P * static_cast<long long>(bl);

  // a thread moves NR / 4 quads of slots of each plane: every load first
  constexpr int NQ = NR / 4;
  const int stride = 4 * blockDim.x;
  {
    uint4 val[NQ][NW];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int i = 4 * threadIdx.x + q * stride;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const uint4* g = reinterpret_cast<const uint4*>(srcs[p] + src_off + i * WPS);
#pragma unroll
        for (int h = 0; h < WPS; ++h) val[q][p * WPS + h] = __ldg(g + h);
      }
    }
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int i = 4 * threadIdx.x + q * stride;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        if constexpr (WPS == 1) {
          put_quad(sm + p * bl, i, val[q][p]);
        } else {  // two 64-bit words a uint4: low halves, then high halves
          const uint4 u = val[q][2 * p];
          const uint4 t = val[q][2 * p + 1];
          put_quad(sm + (2 * p) * bl, i, make_uint4(u.x, u.z, t.x, t.z));
          put_quad(sm + (2 * p + 1) * bl, i, make_uint4(u.y, u.w, t.y, t.w));
        }
      }
    }
  }
  for (int w = 0; w < nm; ++w) {
    uint32_t x[NQ][4];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int i = 4 * threadIdx.x + q * stride;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = 4 * w + j;
        x[q][j] = p < P ? __ldg(reinterpret_cast<const uint32_t*>(
                              mbase + static_cast<long long>(p) * bl + i))
                        : 0u;
      }
    }
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      put_quad(sm + (NW + w) * bl, 4 * threadIdx.x + q * stride,
               mask_words(x[q][0], x[q][1], x[q][2], x[q][3]));
    }
  }
  __syncthreads();
  for (int t = 0; t < sc.nruns; ++t) {
    run_stages<NW, RB, REV>(sm, bl, lbits, sc, REV ? sc.nruns - 1 - t : t);
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int i = 4 * threadIdx.x + q * stride;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      uint4* g = reinterpret_cast<uint4*>(dsts[p] + dst_off + i * WPS);
      if constexpr (WPS == 1) {
        *g = get_quad(sm + p * bl, i);
      } else {
        const uint4 lo = get_quad(sm + (2 * p) * bl, i);
        const uint4 hi = get_quad(sm + (2 * p + 1) * bl, i);
        g[0] = make_uint4(lo.x, hi.x, lo.y, hi.y);
        g[1] = make_uint4(lo.z, hi.z, lo.w, hi.w);
      }
    }
  }
}

inline int mask_words_of(int P) { return (P + 3) / 4; }

inline size_t smem_bytes(int nplanes, int esize, int bl, int P) {
  return static_cast<size_t>(nplanes * esize / 4 + mask_words_of(P)) * bl * 4;
}

// A schedule the kernel can run: rb register bits with 5 lane bits inside
// the block's lbits and at most 1024 threads; runs that cover stages 0..S-1
// in order, each of at most 16 stages inside one 32-stage mask word, each
// assignment a permutation of the slot bits; every stage's code names the
// slot bit of its distance (lg) in its run's assignment.
inline bool sched_ok(const Sched& sc, int S, const unsigned char* lg, int lbits) {
  const int rb = sc.rb;
  if (rb < kMinRegBits || rb > kMaxRegBits || rb + kLaneBits > lbits ||
      (1 << (lbits - rb)) > kMaxThreads || lbits > 16) {
    return false;
  }
  if (sc.nruns < 0 || sc.nruns > kMaxRuns || (S > 0) != (sc.nruns > 0)) return false;
  int next = 0;
  for (int r = 0; r < sc.nruns; ++r) {
    const Run& run = sc.run[r];
    if (run.a != next || run.b <= run.a || run.b > S || run.b - run.a > kMaxRunStages ||
        (run.a >> 5) != ((run.b - 1) >> 5)) {
      return false;
    }
    unsigned seen = 0;
    for (int t = 0; t < lbits; ++t) {
      if (run.perm[t] >= lbits || ((seen >> run.perm[t]) & 1u)) return false;
      seen |= 1u << run.perm[t];
    }
    for (int s = run.a; s < run.b; ++s) {
      const int c = sc.code[s];
      int t;
      if (c < 8) {
        if (c >= rb) return false;
        t = c;
      } else {
        if (c - 8 >= kLaneBits) return false;
        t = rb + c - 8;
      }
      if (run.perm[t] != lg[s]) return false;
    }
    next = run.b;
  }
  return next == S;
}

}  // namespace inner
