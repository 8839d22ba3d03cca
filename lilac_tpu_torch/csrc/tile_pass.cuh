// Shared-memory tile passes of the single-table gather networks, used by
// K1 (routed.cu, forward) and K11 (adjoint.cu, reverse with add-merges).
//
// A network of S stages over m slots (kinds/dists, see routed.cu) is cut on
// the host into passes (kernels/routed.py:routed_passes, from kinds, dists,
// m and the tile T alone). One pass is one grid of one thread block per
// (tile, net). The block loads its tile into dynamic shared memory with
// the mask bytes of the pass's stages, runs those stages there in place,
// and writes the tile back. Three pass kinds:
//
//   low   stages with d < T on a contiguous, aligned tile of T slots. A pass
//         holds either xor stages only (local to the tile, no halo) or
//         shift / shiftl stages only, over a window of the tile plus the
//         halo they can reach: sum(d) of `shift` slots on the left and of
//         `shiftl` on the right (the adjoint: the other way round), cyclic
//         over m. Each stage computes only the window slots the stages
//         still to come can reach (`lo`/`hi`). xor and shifts never share a
//         low pass: the forward wants shifts before xors there, the
//         adjoint the reverse, and one schedule serves both.
//   high  stages with d a multiple of T, T < m <= T^2/4: a tile holds the
//         m/T slots of every high address bit (bits log2 T .. log2 m - 1)
//         for C = T^2/m >= 4 consecutive low slots. An xor by 2^b >= T
//         flips a bit the tile holds, a cyclic shift by k*T moves only the
//         high bits (cyclic over m/T rows): both stay in the tile.
//   stage a stage with d >= T when m > T^2/4: one grid per stage
//         (routed_stage_kernel / adj_stage_kernel), no tile.
//
// Loads are cp.async copies of 16 bytes (4 for the mask words) by all
// threads, not TMA: every thread issues its copies back to back and waits
// once, so the load keeps the whole tile in flight without registers; the
// high tile is m/T strided runs that one TMA box would only cover with a
// 2-D descriptor per pass, and the low window starts at any multiple of 4
// slots, which a TMA box (16-byte aligned global address) also takes but
// gains nothing from while the block waits for its whole tile anyway. Mask bytes: plane s/8 of the
// plan's [B, P, m] layout, read once per pass (every plane the pass's
// stages touch, at most 5 for 32 stages, 3 for the 16 stages of a pass with
// a halo) and staged beside the tile.
//
// In place: an xor stage exchanges disjoint pairs, each pair of 4-slot
// groups by one thread, so it needs no barrier inside. A window shift reads
// one side only (w - d or w + d), so the block sweeps the range in chunks
// away from the side it reads; a chunk reads its groups into registers, one
// barrier, then writes, and a later chunk never reads what an earlier one
// wrote. A group is 4 slots: one 16-byte shared access a plane and one
// 4-byte read of its mask bytes, where one slot at a time took five
// accesses; the forward skips a group none of whose switches is set, the
// adjoint merges every slot. A high shift is cyclic, so the whole tile is
// read into registers (T / threads slots a thread), one barrier, then
// written. Every access is to a group of 4 slots, which C >= 4 keeps
// contiguous in device memory too. One barrier ends every stage.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lilac_tiles {

enum { KIND_XOR = 0, KIND_SHIFT = 1, KIND_SHIFTL = 2 };
enum { PASS_LOW = 0, PASS_HIGH = 1, PASS_STAGE = 2 };
enum { MODE_FWD = 0, MODE_ADJ = 1, MODE_ADJ_DF = 2 };

constexpr int kMaxStages = 32;      // stages of one tile pass
constexpr int kMaxHaloStages = 16;  // stages of a pass with a halo
constexpr int kMinTile = 128;
constexpr int kThreads = 1024;
constexpr int kChunk = 2;  // groups of 4 slots a thread takes per chunk of a window sweep

template <typename T>
struct alignas(sizeof(T) * 4) Quad {
  T v[4];
};

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

// kept + moved for NP planes of one slot. DF: the two planes are one
// (hi, lo) pair: TwoSum of the hi words, the lo words and the error added,
// quick-two-sum renormalisation (the reference's _stage_adj, step for step).
template <typename T, int NP, bool DF>
__device__ __forceinline__ void merge(const T* kept, const T* moved, T* out) {
  if constexpr (DF && NP == 2) {
    const T s = add_rn(kept[0], moved[0]);
    const T bb = sub_rn(s, kept[0]);
    const T e = add_rn(sub_rn(kept[0], sub_rn(s, bb)), sub_rn(moved[0], bb));
    const T low = add_rn(e, add_rn(kept[1], moved[1]));
    const T hi = add_rn(s, low);
    out[0] = hi;
    out[1] = sub_rn(low, sub_rn(hi, s));
  } else {
#pragma unroll
    for (int p = 0; p < NP; ++p) out[p] = add_rn(kept[p], moved[p]);
  }
}

struct TilePass {
  int high;   // 1: high tile, 0: low window
  int n;      // stages s0 .. s0 + n - 1
  int bit0;   // s0 % 8
  int np_m;   // mask planes staged
  long long p0;  // s0 / 8
  int tile;   // slots a block writes (T, or m where m < T)
  int W;      // slots a block holds: tile + dl + dr
  int dl;     // low: window slots left of the tile, a multiple of 4
  int tbits, cbits, hbits;  // high: log2 T, log2 C, log2 (m / T)
  signed char kind[kMaxStages];
  int d[kMaxStages];  // low: slots; high: local xor mask, or rows for a shift
  int lo[kMaxStages], hi[kMaxStages];  // low shifts: window range stage j computes
};

inline int log2i(long long v) {
  int b = 0;
  while ((1ll << b) < v) ++b;
  return b;
}

// Fill one tile pass of stages [s0, s0 + n) in the direction asked for
// (adjoint: the halos swap sides, the ranges grow the other way). False when
// the stages do not make a pass of that kind.
inline bool make_tile_pass(TilePass* ps, int pkind, int s0, int n,
                           const int* kinds, const long long* dists,
                           long long m, int tile, bool adjoint) {
  if (n < 1 || n > kMaxStages || (pkind != PASS_LOW && pkind != PASS_HIGH)) {
    return false;
  }
  const long long t = tile < m ? tile : m;
  ps->high = pkind == PASS_HIGH;
  ps->n = n;
  ps->bit0 = s0 & 7;
  ps->p0 = s0 >> 3;
  ps->np_m = ((s0 + n - 1) >> 3) - (s0 >> 3) + 1;
  ps->tile = static_cast<int>(t);
  ps->tbits = log2i(t);
  ps->hbits = log2i(m) - ps->tbits;
  ps->cbits = ps->tbits - ps->hbits;
  ps->dl = 0;
  ps->W = static_cast<int>(t);
  if (ps->high && !(t < m && ps->cbits >= 2)) return false;  // C >= 4
  long long sum_shift = 0, sum_shiftl = 0;
  int nxor = 0;
  for (int j = 0; j < n; ++j) {
    const int k = kinds[s0 + j];
    const long long d = dists[s0 + j];
    ps->kind[j] = static_cast<signed char>(k);
    if (ps->high) {
      if (d < t || d % t) return false;
      ps->d[j] = static_cast<int>(k == KIND_XOR ? (d >> ps->tbits) << ps->cbits
                                                : d >> ps->tbits);
    } else {
      if (d >= t) return false;
      ps->d[j] = static_cast<int>(d);
      if (k == KIND_XOR) {
        ++nxor;
      } else if (k == KIND_SHIFT) {
        sum_shift += d;
      } else {
        sum_shiftl += d;
      }
    }
  }
  if (ps->high || nxor == n) return true;
  if (nxor || n > kMaxHaloStages) return false;
  // forward `shift` reads w - d (left halo), `shiftl` w + d; the adjoint reads
  // the other side
  const long long left = adjoint ? sum_shiftl : sum_shift;
  const long long right = adjoint ? sum_shift : sum_shiftl;
  const long long dl = (left + 3) & ~3ll;
  const long long dr = (right + 3) & ~3ll;
  if (dl + dr > t) return false;
  ps->dl = static_cast<int>(dl);
  ps->W = static_cast<int>(t + dl + dr);
  // the range of each stage: what the stages run after it still read
  int lo = ps->dl, hi = ps->dl + ps->tile;
  for (int e = 0; e < n; ++e) {
    const int j = adjoint ? e : n - 1 - e;  // stages in reverse run order
    ps->lo[j] = lo;
    ps->hi[j] = hi;
    const bool reads_up = (ps->kind[j] == KIND_SHIFTL) != adjoint;
    if (reads_up) {
      hi += ps->d[j];
    } else {
      lo -= ps->d[j];
    }
  }
  return true;
}

inline size_t tile_pass_smem(const TilePass& ps, int nplanes, int esize) {
  return static_cast<size_t>(ps.W) * (nplanes * esize + ps.np_m);
}

inline int tile_pass_threads(const TilePass& ps) {
  return ps.tile / 4 < kThreads ? ps.tile / 4 : kThreads;
}

// slots a thread holds in registers through a high shift: 16 32-bit
// registers of NP words
__host__ __device__ constexpr int high_slots(int nplanes, int esize) {
  return 16 / (nplanes * esize / 4);
}

// Asynchronous copies into shared memory (cp.async, sm_80 and later): a
// thread issues all its copies back to back, without registers, and waits
// once; the block's barrier after the wait publishes them.
__device__ __forceinline__ void copy16_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void copy4_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// global slot of window position w of tile `tid`
__device__ __forceinline__ long long tile_slot(const TilePass& ps,
                                               long long tid, int w,
                                               long long m) {
  if (ps.high) {
    const long long h = w >> ps.cbits;
    const long long c = w & ((1 << ps.cbits) - 1);
    return (h << ps.tbits) + (tid << ps.cbits) + c;
  }
  return (tid * ps.tile - ps.dl + w) & (m - 1);
}

// Stages work on groups of 4 consecutive slots: one 16-byte shared access
// per plane (two for 64-bit words) and one 4-byte read of the 4 mask bytes.
constexpr uint32_t kLaneBits = 0x01010101u;  // bit 0 of each mask byte

template <typename T>
__device__ __forceinline__ Quad<T>& quad_at(T* u, int w) {
  return *reinterpret_cast<Quad<T>*>(u + w);
}

__device__ __forceinline__ uint32_t lanes_at(const uint8_t* mrow, int w, int bit) {
  return (*reinterpret_cast<const uint32_t*>(mrow + w) >> bit) & kLaneBits;
}

// xor stage over [0, W): group pairs (a, a | d) by one thread (d >= 4), or
// groups holding both partners (d < 4); its own adjoint
template <typename T, int NP>
__device__ __forceinline__ void xor_stage(T* u, int W, const uint8_t* mrow,
                                          int bit, int d) {
  const int nt = blockDim.x;
  if (d >= 4) {
    for (int k = threadIdx.x; k < W / 8; k += nt) {
      const int q = 4 * k;
      const int low = q & (d - 1);
      const int a = ((q - low) << 1) | low;
      const int b = a | d;
      const uint32_t ma = lanes_at(mrow, a, bit);
      const uint32_t mb = lanes_at(mrow, b, bit);
      if (ma | mb) {
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const Quad<T> va = quad_at(u + p * W, a);
          const Quad<T> vb = quad_at(u + p * W, b);
          Quad<T> ra = va, rb = vb;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if ((ma >> (8 * j)) & 1) ra.v[j] = vb.v[j];
            if ((mb >> (8 * j)) & 1) rb.v[j] = va.v[j];
          }
          quad_at(u + p * W, a) = ra;
          quad_at(u + p * W, b) = rb;
        }
      }
    }
  } else {
    for (int g = threadIdx.x; g < W / 4; g += nt) {
      const int w0 = 4 * g;
      const uint32_t mw = lanes_at(mrow, w0, bit);
      if (mw) {
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const Quad<T> v = quad_at(u + p * W, w0);
          Quad<T> r;
#pragma unroll
          for (int j = 0; j < 4; ++j) r.v[j] = ((mw >> (8 * j)) & 1) ? v.v[j ^ d] : v.v[j];
          quad_at(u + p * W, w0) = r;
        }
      }
    }
  }
}

// The 4 lanes of a group from its own words and its partners' (NP planes).
// Forward: the lanes switched in mw take the partner's word. Adjoint: every
// lane of `lanes` merges (own where its switch is clear) + (partner where
// the partner's switch, mv, is set).
template <typename T, int NP, int MODE>
__device__ __forceinline__ void group_update(Quad<T>* own, const Quad<T>* part,
                                             uint32_t mw, uint32_t mv,
                                             uint32_t lanes) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (MODE == MODE_FWD) {
      if ((mw >> (8 * j)) & 1) {
#pragma unroll
        for (int p = 0; p < NP; ++p) own[p].v[j] = part[p].v[j];
      }
    } else {
      if (!((lanes >> (8 * j)) & 1)) continue;
      T kept[NP], moved[NP], res[NP];
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        kept[p] = ((mw >> (8 * j)) & 1) ? T(0) : own[p].v[j];
        moved[p] = ((mv >> (8 * j)) & 1) ? part[p].v[j] : T(0);
      }
      merge<T, NP, MODE == MODE_ADJ_DF>(kept, moved, res);
#pragma unroll
      for (int p = 0; p < NP; ++p) own[p].v[j] = res[p];
    }
  }
}

// The new values of the window group at w0 (lanes w0 .. w0 + 3) for a shift
// reading w + d (up) or w - d; lanes outside [lo, hi) keep their word (no
// stage reads it again). False when the group is left as it is (forward,
// no lane switched). Partner groups are read whole where d % 4 == 0 (they
// stay inside the window: see make_tile_pass), else lane by lane.
template <typename T, int NP, int MODE>
__device__ __forceinline__ bool window_group(const T* u, int W,
                                             const uint8_t* mrow, int bit,
                                             bool up, int d, int lo, int hi,
                                             int w0, Quad<T>* out) {
  uint32_t inr = 0;  // lanes inside the range
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (w0 + j >= lo && w0 + j < hi) inr |= 1u << (8 * j);
  }
  const uint32_t mw = lanes_at(mrow, w0, bit) & (MODE == MODE_FWD ? inr : ~0u);
  if (MODE == MODE_FWD && !mw) return false;
  const int v0 = up ? w0 + d : w0 - d;
  const bool whole = (d & 3) == 0;
  uint32_t mv = 0;
  if (MODE != MODE_FWD) {
    if (whole) {
      mv = lanes_at(mrow, v0, bit);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if ((inr >> (8 * j)) & 1) mv |= ((mrow[v0 + j] >> bit) & 1u) << (8 * j);
      }
    }
  }
  Quad<T> part[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const T* plane = u + p * W;
    out[p] = *reinterpret_cast<const Quad<T>*>(plane + w0);
    if (whole) {
      part[p] = *reinterpret_cast<const Quad<T>*>(plane + v0);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) part[p].v[j] = ((inr >> (8 * j)) & 1) ? plane[v0 + j] : T(0);
    }
  }
  group_update<T, NP, MODE>(out, part, mw, mv, inr);
  return true;
}

// shift of a low window over [lo, hi), reading w + d (up) or w - d: groups
// of 4 slots in chunks swept away from the side read
template <typename T, int NP, int MODE>
__device__ __forceinline__ void window_stage(T* u, int W, const uint8_t* mrow,
                                             int bit, bool up, int d, int lo,
                                             int hi) {
  const int nt = blockDim.x;
  const int glo = lo & ~3;
  const int ghi = (hi + 3) & ~3;
  // the adjoint holds partners beside its own words: one group a chunk
  constexpr int G = MODE == MODE_FWD ? kChunk : 1;
  const int chunk = G * 4 * nt;
  for (int c = 0; c < ghi - glo; c += chunk) {
    const int base = up ? glo + c : ghi - c - chunk;  // may be below glo: masked
    Quad<T> out[G][NP];
    bool act[G];
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int w0 = base + 4 * (i * nt + static_cast<int>(threadIdx.x));
      act[i] = w0 >= glo && w0 < ghi &&
               window_group<T, NP, MODE>(u, W, mrow, bit, up, d, lo, hi, w0, out[i]);
    }
    __syncthreads();  // the chunk is read: its slots may change
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int w0 = base + 4 * (i * nt + static_cast<int>(threadIdx.x));
      if (act[i]) {
#pragma unroll
        for (int p = 0; p < NP; ++p) quad_at(u + p * W, w0) = out[i][p];
      }
    }
  }
}

// cyclic shift of a high tile by d rows (up: row h + d): all of it read
// into registers, then written; a group and its partner lie in one row
// each (C >= 4)
template <typename T, int NP, int MODE>
__device__ __forceinline__ void cyclic_stage(T* u, int W, const uint8_t* mrow,
                                             int bit, bool up, int d,
                                             int cbits, int hbits) {
  constexpr int GP = high_slots(NP, sizeof(T)) / 4;
  const int nt = blockDim.x;
  const int cmask = (1 << cbits) - 1;
  const int hmask = (1 << hbits) - 1;
  Quad<T> out[GP][NP];
  bool act[GP];
#pragma unroll
  for (int i = 0; i < GP; ++i) {
    const int w0 = 4 * (i * nt + static_cast<int>(threadIdx.x));
    const uint32_t mw = w0 < W ? lanes_at(mrow, w0, bit) : 0u;
    act[i] = w0 < W && (MODE != MODE_FWD || mw);
    if (act[i]) {
      const int h = w0 >> cbits;
      const int v0 = (((up ? h + d : h - d) & hmask) << cbits) | (w0 & cmask);
      const uint32_t mv = MODE == MODE_FWD ? 0u : lanes_at(mrow, v0, bit);
      Quad<T> part[NP];
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        out[i][p] = quad_at(u + p * W, w0);
        part[p] = quad_at(u + p * W, v0);
      }
      group_update<T, NP, MODE>(out[i], part, mw, mv, kLaneBits);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < GP; ++i) {
    if (act[i]) {
      const int w0 = 4 * (i * nt + static_cast<int>(threadIdx.x));
#pragma unroll
      for (int p = 0; p < NP; ++p) quad_at(u + p * W, w0) = out[i][p];
    }
  }
}

// grid (tiles, B). s0/s1 input planes with sstride words between nets (0:
// one table shared by all nets), d0/d1 output planes [B, m], masks
// [B, P, m] bytes with mstride = P * m. MODE_FWD runs the stages in order,
// the adjoint modes in reverse.
template <typename T, int NP, int MODE>
__global__ void __launch_bounds__(kThreads)
    tile_pass_kernel(const T* __restrict__ s0, const T* __restrict__ s1,
                     long long sstride, T* __restrict__ d0, T* __restrict__ d1,
                     const uint8_t* __restrict__ masks, long long mstride,
                     long long m, TilePass ps) {
  extern __shared__ __align__(32) unsigned char smem_raw[];
  const int W = ps.W;
  T* u = reinterpret_cast<T*>(smem_raw);
  uint8_t* mk = smem_raw + static_cast<size_t>(NP) * W * sizeof(T);
  const long long tid = blockIdx.x;
  const long long net = blockIdx.y;
  const T* srcs[2] = {s0 + net * sstride, NP == 2 ? s1 + net * sstride : nullptr};
  T* dsts[2] = {d0 + net * m, NP == 2 ? d1 + net * m : nullptr};
  const uint8_t* mnet = masks + net * mstride + ps.p0 * m;

  for (int q = threadIdx.x; q < W / 4; q += blockDim.x) {
    const int w = q * 4;
    const long long g = tile_slot(ps, tid, w, m);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
#pragma unroll
      for (int h = 0; h < static_cast<int>(sizeof(T)) / 4; ++h) {
        copy16_async(u + p * W + w + 2 * h, srcs[p] + g + 2 * h);
      }
    }
    for (int k = 0; k < ps.np_m; ++k) {
      copy4_async(mk + k * W + w, mnet + k * m + g);
    }
  }
  copies_wait();
  __syncthreads();

  for (int e = 0; e < ps.n; ++e) {
    const int j = MODE == MODE_FWD ? e : ps.n - 1 - e;
    const int sb = ps.bit0 + j;
    const uint8_t* mrow = mk + (sb >> 3) * W;
    const int bit = sb & 7;
    const int kind = ps.kind[j];
    // forward shiftl and the adjoint of shift read upwards
    const bool up = (kind == KIND_SHIFTL) != (MODE != MODE_FWD);
    if (kind == KIND_XOR) {
      xor_stage<T, NP>(u, W, mrow, bit, ps.d[j]);
    } else if (ps.high) {
      cyclic_stage<T, NP, MODE>(u, W, mrow, bit, up, ps.d[j], ps.cbits, ps.hbits);
    } else {
      window_stage<T, NP, MODE>(u, W, mrow, bit, up, ps.d[j], ps.lo[j], ps.hi[j]);
    }
    __syncthreads();
  }

  for (int q = threadIdx.x; q < ps.tile / 4; q += blockDim.x) {
    const int w = ps.dl + q * 4;
    const long long g = tile_slot(ps, tid, w, m);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      *reinterpret_cast<Quad<T>*>(dsts[p] + g) =
          *reinterpret_cast<const Quad<T>*>(u + p * W + w);
    }
  }
}

// Check a pass list against the stages and build every tile pass before
// anything is launched: passes cover [0, S) in order, a stage pass holds one
// stage, each tile pass fits the device's opt-in shared memory and the high
// shift's registers. ps[q].n = 0 marks a stage pass.
inline cudaError_t plan_passes(TilePass* ps, int npass, const int* pkind,
                               const int* pstart, int S, const int* kinds,
                               const long long* dists, long long m, int tile,
                               bool adjoint, int nplanes, int esize) {
  if (tile < kMinTile || (tile & (tile - 1)) != 0 || npass < 1 || npass > S) {
    return cudaErrorInvalidValue;
  }
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const int per = high_slots(nplanes, esize);
  for (int q = 0; q < npass; ++q) {
    const int s0 = pstart[q];
    const int s1 = q + 1 < npass ? pstart[q + 1] : S;
    if ((q == 0 && s0 != 0) || s1 <= s0) return cudaErrorInvalidValue;
    if (pkind[q] == PASS_STAGE) {
      if (s1 - s0 != 1) return cudaErrorInvalidValue;
      ps[q].n = 0;
      continue;
    }
    if (!make_tile_pass(&ps[q], pkind[q], s0, s1 - s0, kinds, dists, m, tile,
                        adjoint)) {
      return cudaErrorInvalidValue;
    }
    if (tile_pass_smem(ps[q], nplanes, esize) > static_cast<size_t>(optin) ||
        (ps[q].high && ps[q].W > per * tile_pass_threads(ps[q]))) {
      return cudaErrorInvalidValue;
    }
  }
  return cudaSuccess;
}

template <typename T, int NP, int MODE>
cudaError_t launch_tile_pass(const TilePass& ps, const T* s0, const T* s1,
                             long long sstride, T* d0, T* d1,
                             const uint8_t* masks, long long mstride,
                             long long m, int B, cudaStream_t stream) {
  // the limit above 48 KB, raised once per device for this instantiation
  static int raised[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (!raised[dev & 63]) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(tile_pass_kernel<T, NP, MODE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
    raised[dev & 63] = 1;
  }
  const size_t smem = tile_pass_smem(ps, NP, sizeof(T));
  dim3 grid(static_cast<unsigned>(m / ps.tile), static_cast<unsigned>(B));
  tile_pass_kernel<T, NP, MODE><<<grid, tile_pass_threads(ps), smem, stream>>>(
      s0, s1, sstride, d0, d1, masks, mstride, m, ps);
  return cudaGetLastError();
}

}  // namespace lilac_tiles
