// K3-K6: the four forward passes of a hierarchical gather network, for
// Hopper (sm_90a), and the two adjoint passes that only move words, K7 and
// K8. They replace the Pallas kernels of lilac_tpu/kernels/routed.py:
//   K3 routed_apply_sliced_b / routed_apply_sliced   (inner pass)
//   K4 butterfly_apply_b     / butterfly_apply       (butterfly pass)
//   K5 window_shift_apply_b  / window_shift_apply    (window pass)
//   K6 bigshift_apply_b      / bigshift_apply        (block-aligned shift)
//   K7 routed_apply_sliced_bt                        (inner pass, adjoint)
//   K8 butterfly_apply_bt                            (butterfly, adjoint)
// The un-batched functions are the same kernels at N = 1 net. An xor stage
// is an exchange, its own inverse and its own adjoint, so K7 and K8 are the
// kernels of K3 and K4 instantiated with the stage loop running backwards
// (REV). The inner pass (K3, K3u, K7) is in inner_pass.cuh. The adjoint
// passes that add (window, bigshift) are in adjoint.cu.
//
// A network of m = nblocks * bl slots is applied pass by pass. Every pass
// reads N nets' planes (or one shared input plane for all N nets, net
// stride 0) and writes N planes. A pass reads LOGICAL block b from physical
// block phys(b), where phys is a permutation of the block-index bits
// (`layout`: physical bit k holds logical bit layout[k]), because a
// butterfly pass leaves its groups contiguous (group-major) instead of
// moving them back. K3, K5 and K6 write natural order.
//
// The kernels only move words: they are instantiated on the word width (32
// or 64 bit) and the plane count (one plane, or a df64 (hi, lo) pair routed
// through identical switches), so results are bit-identical to the plain
// PyTorch versions whatever the values are. Mask layouts are the plan
// file's (see each kernel).
//
// Bound: bytes, for all four. A pass reads each slot's word(s) and its mask
// byte(s) once and writes each word once. What the design does about it:
//   K3 keeps one block of bl slots in a thread block: its stages run in
//      registers and warp shuffles, a few runs of them with one pass through
//      shared memory between runs (inner_pass.cuh).
//   K4 holds nothing on chip: a thread reads its offset's word from each of
//      the 2^g member blocks, exchanges them in registers, writes them
//      group-major.
//   K5 needs no resident window. y[i] <- m_s[i] ? y[i - d_s] : y[i] over
//      <= 8 stages composes into one gather: walking the stages backwards
//      from output slot i through the mask bits gives the slot the value
//      came from, at most sum(d) to its left. A block is cut into bl / C
//      thread blocks of C output slots (C = 128: 4096 thread blocks of 32
//      threads for one net at m = 2^19, bl = 2^13, where whole blocks gave
//      64 for 132 SMs; C = 1024 took 0.333 ms against 0.293 at class D's
//      shapes on an H100 80GB HBM3 at 700 W). Each stages only the mask
//      bytes its walks can read, [bl + c0 - sum(d), bl + c0 + C) of the
//      (left, self) window, with 16-byte cp.async; a thread walks 4
//      consecutive slots, reads their sources through L1 (one vector load
//      where the 4 are consecutive) and stores them as one vector a plane.
//      Staging the sources in shared memory, or loading a thread's own
//      words while its mask bytes arrive, measured slower.
//   K6 is one select between two blocks.
// Shared memory bounds bl through the plan's budget for a window pass, one
// window of bl + sum(d) slots and their mask bytes (kernels/routed.py:
// pass_smem_bytes and check_smem_feasible), not through these kernels; K9
// (adjoint.cu) stages two buffers of only span + sum(d) slots, within that
// budget. The inner pass takes at most 2^14 slots, 1024 threads of 16.

#include <cuda_runtime.h>
#include <stdint.h>

#include "inner_pass.cuh"

namespace {

using Layout = inner::BlockLayout;
using inner::phys_of;

template <typename T>
struct alignas(sizeof(T) * 4) Quad {
  T v[4];
};

// ------------------------------------------------------------ K4 butterfly

struct BflyMap {
  int nrest;                  // block bits outside the pass
  unsigned char gid_pos[32];  // physical bit position of group-index bit i
  int mem_phys[8];            // physical block bits set by member s
};

// grid (ceil(bl / (4 * threads)), ngroups, N). masks [N, ngroups, G, bl]
// bytes, member-major: bit k of member s's byte is stage k's switch.
template <typename T, int NP, int LG, bool REV>
__global__ void hier_butterfly_kernel(const T* __restrict__ s0,
                                      const T* __restrict__ s1,
                                      long long sstride, T* __restrict__ d0,
                                      T* __restrict__ d1, long long m, int bl,
                                      const uint8_t* __restrict__ masks,
                                      BflyMap map) {
  constexpr int G = 1 << LG;
  const int off = (blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (off >= bl) return;
  const long long gid = blockIdx.y;
  const long long n = blockIdx.z;
  const long long ngroups = gridDim.y;
  long long pg = 0;
  for (int i = 0; i < map.nrest; ++i) {
    pg |= ((gid >> i) & 1ll) << map.gid_pos[i];
  }
  const T* srcs[2] = {s0, s1};
  T* dsts[2] = {d0, d1};
  Quad<T> cur[NP][G];
  uint32_t mw[G];
  const uint8_t* mbase = masks + (n * ngroups + gid) * G * bl + off;
#pragma unroll
  for (int s = 0; s < G; ++s) {
    mw[s] = *reinterpret_cast<const uint32_t*>(mbase + static_cast<long long>(s) * bl);
    const long long src = n * sstride + (pg | map.mem_phys[s]) * bl + off;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      cur[p][s] = *reinterpret_cast<const Quad<T>*>(srcs[p] + src);
    }
  }
#pragma unroll
  for (int kk = 0; kk < LG; ++kk) {
    const int k = REV ? LG - 1 - kk : kk;
#pragma unroll
    for (int s = 0; s < G; ++s) {
      if (s & (1 << k)) continue;
      const int t = s | (1 << k);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ms = (mw[s] >> (8 * j + k)) & 1u;
        const bool mt = (mw[t] >> (8 * j + k)) & 1u;
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const T a = cur[p][s].v[j];
          const T c = cur[p][t].v[j];
          cur[p][s].v[j] = ms ? c : a;
          cur[p][t].v[j] = mt ? a : c;
        }
      }
    }
  }
#pragma unroll
  for (int s = 0; s < G; ++s) {
    const long long dst = n * m + (gid * G + s) * bl + off;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      *reinterpret_cast<Quad<T>*>(dsts[p] + dst) = cur[p][s];
    }
  }
}

// --------------------------------------------------------------- K5 window

struct Shifts {
  int n;
  int d[8];
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// grid (nblocks * bl / span, N), span / 4 threads: thread block x serves
// output slots [c0, c0 + span) of block x / (bl / span). masks [N, nblocks,
// 2 * bl] bytes (16-byte aligned): the first bl are the left neighbour's
// switches (zero for block 0), bit s is stage s. Shared memory: the mask
// bytes of window positions [w0, bl + c0 + span), w0 = (bl + c0 - sum(d))
// & ~15, by 16-byte cp.async.
template <typename T, int NP>
__global__ void __launch_bounds__(1024)
    hier_window_kernel(const T* __restrict__ s0, const T* __restrict__ s1,
                       long long sstride, T* __restrict__ d0, T* __restrict__ d1,
                       long long m, int bl, const uint8_t* __restrict__ masks,
                       Shifts sh, int sumd, int span, Layout lay) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* mk = smem_raw;
  const int parts = bl / span;
  const long long b = blockIdx.x / parts;
  const int c0 = (blockIdx.x % parts) * span;
  const long long n = blockIdx.y;
  const long long nblocks = gridDim.x / parts;
  const int w0 = (bl + c0 - sumd) & ~15;
  {
    const uint8_t* g = masks + (n * nblocks + b) * 2 * bl + w0;
    const int chunks = (bl + c0 + span - w0) / 16;
    for (int j = threadIdx.x; j < chunks; j += blockDim.x) cp_async16(mk + 16 * j, g + 16 * j);
    asm volatile("cp.async.wait_all;" ::: "memory");
  }
  __syncthreads();
  // block 0's left neighbour is block nblocks - 1 (its switches are zero,
  // but a switch of block 0 itself may still reach across)
  const long long left = n * sstride + phys_of((b + nblocks - 1) % nblocks, lay) * bl;
  const long long self = n * sstride + phys_of(b, lay) * bl;
  const int i0 = c0 + 4 * threadIdx.x;
  long long src[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int w = bl + i0 + j;  // position in the (left, self) window
    for (int s = sh.n - 1; s >= 0; --s) {
      if ((mk[w - w0] >> s) & 1) w -= sh.d[s];  // sum(d) < bl keeps w > 0
    }
    src[j] = (w >= bl) ? self + (w - bl) : left + w;
  }
  // the four sources in a row from a multiple of 4: one aligned vector load
  const bool run = src[1] == src[0] + 1 && src[2] == src[0] + 2 &&
                   src[3] == src[0] + 3 && (src[0] & 3) == 0;
  const long long dst = n * m + b * bl + i0;
  const T* srcs[2] = {s0, s1};
  T* dsts[2] = {d0, d1};
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    Quad<T> q;
    if (run) {
      q = *reinterpret_cast<const Quad<T>*>(srcs[p] + src[0]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) q.v[j] = __ldg(srcs[p] + src[j]);
    }
    *reinterpret_cast<Quad<T>*>(dsts[p] + dst) = q;
  }
}

// ------------------------------------------------------------- K6 bigshift

// grid (ceil(bl / (4 * threads)), nblocks, N). masks [N, nblocks, bl]
// bytes, non-zero = take the word of logical block b - db.
template <typename T, int NP>
__global__ void hier_bigshift_kernel(const T* __restrict__ s0,
                                     const T* __restrict__ s1,
                                     long long sstride, T* __restrict__ d0,
                                     T* __restrict__ d1, long long m, int bl,
                                     const uint8_t* __restrict__ masks,
                                     long long db, Layout lay) {
  const int off = (blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (off >= bl) return;
  const long long b = blockIdx.y;
  const long long n = blockIdx.z;
  const long long nblocks = gridDim.y;
  const long long far = n * sstride + phys_of((b + nblocks - db) % nblocks, lay) * bl + off;
  const long long self = n * sstride + phys_of(b, lay) * bl + off;
  const long long dst = n * m + b * bl + off;
  const uint32_t mw =
      *reinterpret_cast<const uint32_t*>(masks + (n * nblocks + b) * bl + off);
  const T* srcs[2] = {s0, s1};
  T* dsts[2] = {d0, d1};
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    Quad<T> q = *reinterpret_cast<const Quad<T>*>(srcs[p] + self);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if ((mw >> (8 * j)) & 0xffu) q.v[j] = srcs[p][far + j];
    }
    *reinterpret_cast<Quad<T>*>(dsts[p] + dst) = q;
  }
}

// ------------------------------------------------------------- launchers

bool fill_layout(Layout* lay, int nbits, const unsigned char* src) {
  if (nbits < 0 || nbits > 32) return false;
  lay->nbits = nbits;
  for (int k = 0; k < 32; ++k) lay->src[k] = k < nbits ? src[k] : 0;
  return true;
}

// raises a kernel's dynamic shared memory limit (48 KB unless asked) once
// per device and size it has seen
struct SmemAllowed {
  size_t bytes[64] = {};
};

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, SmemAllowed* allowed) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  size_t* seen = &allowed->bytes[dev & 63];
  if (bytes <= *seen) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess) *seen = bytes;
  return err;
}

int block_threads(int work) {
  int t = 1024;
  while (t > 32 && t > work) t >>= 1;
  return t;
}

template <int ES, int NP, int RB, bool REV>
cudaError_t launch_inner_rb(const void* s0, const void* s1, long long sstride,
                            void* d0, void* d1, long long m, int N, int bl,
                            int lbits, const void* masks, int P,
                            const inner::Sched& sc, const Layout& lay,
                            cudaStream_t stream) {
  static SmemAllowed allowed;
  auto* kern = inner::kernel<ES, NP, RB, REV>;
  const size_t smem = inner::smem_bytes(NP, ES, bl, P);
  cudaError_t err = allow_smem(kern, smem, &allowed);
  if (err != cudaSuccess) return err;
  dim3 grid(static_cast<unsigned>(m / bl), static_cast<unsigned>(N));
  kern<<<grid, bl >> RB, smem, stream>>>(
      static_cast<const uint32_t*>(s0), static_cast<const uint32_t*>(s1), sstride,
      static_cast<uint32_t*>(d0), static_cast<uint32_t*>(d1), m, bl, lbits,
      static_cast<const uint8_t*>(masks), P, sc, lay);
  return cudaGetLastError();
}

template <int ES, int NP, bool REV>
cudaError_t launch_inner_dir(const void* s0, const void* s1, long long sstride,
                             void* d0, void* d1, long long m, int N, int bl,
                             int lbits, const void* masks, int P,
                             const inner::Sched& sc, const Layout& lay,
                             cudaStream_t stream) {
  switch (sc.rb) {
    case 2:
      return launch_inner_rb<ES, NP, 2, REV>(s0, s1, sstride, d0, d1, m, N, bl, lbits, masks, P, sc, lay, stream);
    case 3:
      return launch_inner_rb<ES, NP, 3, REV>(s0, s1, sstride, d0, d1, m, N, bl, lbits, masks, P, sc, lay, stream);
    default:
      return launch_inner_rb<ES, NP, 4, REV>(s0, s1, sstride, d0, d1, m, N, bl, lbits, masks, P, sc, lay, stream);
  }
}

// the word width as template arguments (bytes, planes); T only names it
template <typename T, int NP>
cudaError_t launch_inner(bool rev, const void* s0, const void* s1,
                         long long sstride, void* d0, void* d1, long long m,
                         int N, int bl, int lbits, const void* masks, int P,
                         const inner::Sched& sc, const Layout& lay,
                         cudaStream_t stream) {
  constexpr int ES = sizeof(T);
  if (rev) {
    return launch_inner_dir<ES, NP, true>(s0, s1, sstride, d0, d1, m, N, bl, lbits, masks, P, sc, lay, stream);
  }
  return launch_inner_dir<ES, NP, false>(s0, s1, sstride, d0, d1, m, N, bl, lbits, masks, P, sc, lay, stream);
}

template <typename T, int NP, int LG, bool REV>
cudaError_t launch_butterfly_g(const void* s0, const void* s1,
                               long long sstride, void* d0, void* d1,
                               long long m, int N, int bl, const void* masks,
                               const BflyMap& map, cudaStream_t stream) {
  const int threads = block_threads(bl / 4) > 256 ? 256 : block_threads(bl / 4);
  dim3 grid(static_cast<unsigned>((bl / 4 + threads - 1) / threads),
            static_cast<unsigned>((m / bl) >> LG), static_cast<unsigned>(N));
  hier_butterfly_kernel<T, NP, LG, REV><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(s0), static_cast<const T*>(s1), sstride,
      static_cast<T*>(d0), static_cast<T*>(d1), m, bl,
      static_cast<const uint8_t*>(masks), map);
  return cudaGetLastError();
}

template <typename T, int NP, bool REV>
cudaError_t launch_butterfly_dir(int g, const void* s0, const void* s1,
                                 long long sstride, void* d0, void* d1,
                                 long long m, int N, int bl, const void* masks,
                                 const BflyMap& map, cudaStream_t stream) {
  if (g == 1) {
    return launch_butterfly_g<T, NP, 1, REV>(s0, s1, sstride, d0, d1, m, N, bl, masks, map, stream);
  }
  if (g == 2) {
    return launch_butterfly_g<T, NP, 2, REV>(s0, s1, sstride, d0, d1, m, N, bl, masks, map, stream);
  }
  return launch_butterfly_g<T, NP, 3, REV>(s0, s1, sstride, d0, d1, m, N, bl, masks, map, stream);
}

template <typename T, int NP>
cudaError_t launch_butterfly(bool rev, int g, const void* s0, const void* s1,
                             long long sstride, void* d0, void* d1,
                             long long m, int N, int bl, const void* masks,
                             const BflyMap& map, cudaStream_t stream) {
  if (rev) {
    return launch_butterfly_dir<T, NP, true>(g, s0, s1, sstride, d0, d1, m, N, bl, masks, map, stream);
  }
  return launch_butterfly_dir<T, NP, false>(g, s0, s1, sstride, d0, d1, m, N, bl, masks, map, stream);
}

// shared memory of a window thread block: the mask bytes of its span and of
// the sum(d) positions before it, from a 16-byte boundary
int window_smem(int span, int sumd) { return (span + sumd + 15 + 15) & ~15; }

template <typename T, int NP>
cudaError_t launch_window(const void* s0, const void* s1, long long sstride,
                          void* d0, void* d1, long long m, int N, int bl,
                          const void* masks, const Shifts& sh, int sumd, int span,
                          const Layout& lay, cudaStream_t stream) {
  static SmemAllowed allowed;
  const size_t smem = window_smem(span, sumd);
  cudaError_t err = allow_smem(hier_window_kernel<T, NP>, smem, &allowed);
  if (err != cudaSuccess) return err;
  dim3 grid(static_cast<unsigned>(m / bl * (bl / span)), static_cast<unsigned>(N));
  hier_window_kernel<T, NP><<<grid, span / 4, smem, stream>>>(
      static_cast<const T*>(s0), static_cast<const T*>(s1), sstride,
      static_cast<T*>(d0), static_cast<T*>(d1), m, bl,
      static_cast<const uint8_t*>(masks), sh, sumd, span, lay);
  return cudaGetLastError();
}

template <typename T, int NP>
cudaError_t launch_bigshift(const void* s0, const void* s1, long long sstride,
                            void* d0, void* d1, long long m, int N, int bl,
                            const void* masks, long long db,
                            const Layout& lay, cudaStream_t stream) {
  const int threads = block_threads(bl / 4) > 256 ? 256 : block_threads(bl / 4);
  dim3 grid(static_cast<unsigned>((bl / 4 + threads - 1) / threads),
            static_cast<unsigned>(m / bl), static_cast<unsigned>(N));
  hier_bigshift_kernel<T, NP><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(s0), static_cast<const T*>(s1), sstride,
      static_cast<T*>(d0), static_cast<T*>(d1), m, bl,
      static_cast<const uint8_t*>(masks), db, lay);
  return cudaGetLastError();
}

// bl a power of two >= 128, m a power-of-two multiple of bl; blocks, groups
// and nets go into grid.y / grid.z (at most 65535 each; K3 and K5 could
// take more blocks, the limit is kept common); one or two planes of 4- or
// 8-byte words
bool shape_ok(long long m, int N, int bl, int nplanes, int esize) {
  if (bl < 128 || (bl & (bl - 1)) != 0 || m < bl || (m & (m - 1)) != 0) return false;
  if (m / bl > 65535 || N < 1 || N > 65535) return false;
  return (nplanes == 1 || nplanes == 2) && (esize == 4 || esize == 8);
}

}  // namespace

#define LILAC_DISPATCH(FN, ...)                                               \
  (esize == 4 ? (nplanes == 1 ? FN<uint32_t, 1>(__VA_ARGS__)                  \
                              : FN<uint32_t, 2>(__VA_ARGS__))                 \
              : (nplanes == 1 ? FN<unsigned long long, 1>(__VA_ARGS__)        \
                              : FN<unsigned long long, 2>(__VA_ARGS__)))

// Common arguments: s0/s1 input planes (s1 unused when nplanes == 1) with
// `sstride` words between nets (0: one shared plane for all nets), d0/d1
// output planes [N, m], esize 4 or 8 bytes a word, masks in the layout each
// kernel states, layout[nbits] the block-bit permutation of the input.
// Every function returns the cudaError_t of its launch.

namespace {

int run_inner(bool rev, const void* s0, const void* s1, int nplanes, int esize,
              long long sstride, void* d0, void* d1, long long m, int N, int bl,
              const void* masks, int P, int S, const unsigned char* lg,
              int nbits, const unsigned char* layout, const void* sched,
              void* stream) {
  Layout lay;
  if (!shape_ok(m, N, bl, nplanes, esize) || S < 0 || S > inner::kMaxStages ||
      (S > 0 && P != (S + 7) / 8) || !fill_layout(&lay, nbits, layout) ||
      sched == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int lbits = 0;
  while ((1 << lbits) < bl) ++lbits;
  for (int s = 0; s < S; ++s) {
    if (lg[s] >= lbits) return static_cast<int>(cudaErrorInvalidValue);
  }
  const inner::Sched& sc = *static_cast<const inner::Sched*>(sched);
  if (!inner::sched_ok(sc, S, lg, lbits)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  return static_cast<int>(LILAC_DISPATCH(launch_inner, rev, s0, s1, sstride, d0,
                                         d1, m, N, bl, lbits, masks, P, sc, lay, cs));
}

}  // namespace

// lg[S]: log2 of each xor distance, in the forward's stage order for both;
// sched: the pass's inner::Sched (kernels/routed.py:inner_runs), checked
// against lg before the launch.
extern "C" int lilac_hier_inner(const void* s0, const void* s1, int nplanes,
                                int esize, long long sstride, void* d0,
                                void* d1, long long m, int N, int bl,
                                const void* masks, int P, int S,
                                const unsigned char* lg, int nbits,
                                const unsigned char* layout, const void* sched,
                                void* stream) {
  return run_inner(false, s0, s1, nplanes, esize, sstride, d0, d1, m, N, bl,
                   masks, P, S, lg, nbits, layout, sched, stream);
}

// K7: the same stages, last one first (runs in reverse order too).
extern "C" int lilac_hier_inner_t(const void* s0, const void* s1, int nplanes,
                                  int esize, long long sstride, void* d0,
                                  void* d1, long long m, int N, int bl,
                                  const void* masks, int P, int S,
                                  const unsigned char* lg, int nbits,
                                  const unsigned char* layout, const void* sched,
                                  void* stream) {
  return run_inner(true, s0, s1, nplanes, esize, sstride, d0, d1, m, N, bl,
                   masks, P, S, lg, nbits, layout, sched, stream);
}

namespace {

template <int ES, int NP, int RB>
cudaError_t inner_attrs_rb(int bl, int P, int* threads, int* smem, int* ctas,
                           int* regs, int* local_bytes) {
  static SmemAllowed allowed;
  auto* kern = inner::kernel<ES, NP, RB, false>;
  const size_t bytes = inner::smem_bytes(NP, ES, bl, P);
  cudaError_t err = allow_smem(kern, bytes, &allowed);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kern);
  if (err != cudaSuccess) return err;
  *threads = bl >> RB;
  *smem = static_cast<int>(bytes);
  *regs = fa.numRegs;
  *local_bytes = static_cast<int>(fa.localSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kern, *threads, bytes);
}

template <typename T, int NP>
cudaError_t inner_attrs(int rb, int bl, int P, int* threads, int* smem, int* ctas,
                        int* regs, int* local_bytes) {
  constexpr int ES = sizeof(T);
  if (rb == 2) return inner_attrs_rb<ES, NP, 2>(bl, P, threads, smem, ctas, regs, local_bytes);
  if (rb == 3) return inner_attrs_rb<ES, NP, 3>(bl, P, threads, smem, ctas, regs, local_bytes);
  return inner_attrs_rb<ES, NP, 4>(bl, P, threads, smem, ctas, regs, local_bytes);
}

}  // namespace

// How the inner pass launches for one shape: threads and dynamic shared
// memory a thread block, thread blocks resident on one SM, registers a
// thread and local (spilled) bytes of the kernel. For reports only.
extern "C" int lilac_hier_inner_attrs(int nplanes, int esize, int bl, int P, int rb,
                                      int* out) {
  if (!shape_ok(bl, 1, bl, nplanes, esize) || rb < inner::kMinRegBits ||
      rb > inner::kMaxRegBits || (bl >> rb) > inner::kMaxThreads || (bl >> rb) < 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(LILAC_DISPATCH(inner_attrs, rb, bl, P, &out[0], &out[1],
                                         &out[2], &out[3], &out[4]));
}

namespace {

int run_butterfly(bool rev, const void* s0, const void* s1, int nplanes,
                  int esize, long long sstride, void* d0, void* d1, long long m,
                  int N, int bl, const void* masks, int g, int nrest,
                  const unsigned char* gid_pos, const int* mem_phys,
                  void* stream) {
  if (!shape_ok(m, N, bl, nplanes, esize) || g < 1 || g > 3 || nrest < 0 ||
      nrest > 32 || (m / bl) >> g < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BflyMap map;
  map.nrest = nrest;
  for (int i = 0; i < 32; ++i) map.gid_pos[i] = i < nrest ? gid_pos[i] : 0;
  for (int s = 0; s < 8; ++s) map.mem_phys[s] = s < (1 << g) ? mem_phys[s] : 0;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  return static_cast<int>(LILAC_DISPATCH(launch_butterfly, rev, g, s0, s1,
                                         sstride, d0, d1, m, N, bl, masks, map,
                                         cs));
}

}  // namespace

// gid_pos[nrest]: physical bit position of each group-index bit;
// mem_phys[2^g]: physical block bits of each member.
extern "C" int lilac_hier_butterfly(const void* s0, const void* s1, int nplanes,
                                    int esize, long long sstride, void* d0,
                                    void* d1, long long m, int N, int bl,
                                    const void* masks, int g, int nrest,
                                    const unsigned char* gid_pos,
                                    const int* mem_phys, void* stream) {
  return run_butterfly(false, s0, s1, nplanes, esize, sstride, d0, d1, m, N, bl,
                       masks, g, nrest, gid_pos, mem_phys, stream);
}

// K8: the same g exchange stages, last one first.
extern "C" int lilac_hier_butterfly_t(const void* s0, const void* s1,
                                      int nplanes, int esize, long long sstride,
                                      void* d0, void* d1, long long m, int N,
                                      int bl, const void* masks, int g,
                                      int nrest, const unsigned char* gid_pos,
                                      const int* mem_phys, void* stream) {
  return run_butterfly(true, s0, s1, nplanes, esize, sstride, d0, d1, m, N, bl,
                       masks, g, nrest, gid_pos, mem_phys, stream);
}

// span: output slots a thread block, a power of two from 128 to
// min(bl, 4096); masks 16-byte aligned.
extern "C" int lilac_hier_window(const void* s0, const void* s1, int nplanes,
                                 int esize, long long sstride, void* d0,
                                 void* d1, long long m, int N, int bl,
                                 const void* masks, int S, const int* dists,
                                 int nbits, const unsigned char* layout, int span,
                                 void* stream) {
  Shifts sh;
  Layout lay;
  if (!shape_ok(m, N, bl, nplanes, esize) || S < 0 || S > 8 ||
      !fill_layout(&lay, nbits, layout) || span < 128 || span > 4096 || span > bl ||
      (span & (span - 1)) != 0 || reinterpret_cast<uintptr_t>(masks) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int total = 0;
  sh.n = S;
  for (int s = 0; s < 8; ++s) {
    sh.d[s] = s < S ? dists[s] : 0;
    if (s < S && dists[s] < 1) return static_cast<int>(cudaErrorInvalidValue);
    total += sh.d[s];
  }
  if (total >= bl) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  return static_cast<int>(LILAC_DISPATCH(launch_window, s0, s1, sstride, d0, d1,
                                         m, N, bl, masks, sh, total, span, lay, cs));
}

extern "C" int lilac_hier_bigshift(const void* s0, const void* s1, int nplanes,
                                   int esize, long long sstride, void* d0,
                                   void* d1, long long m, int N, int bl,
                                   const void* masks, long long db, int nbits,
                                   const unsigned char* layout, void* stream) {
  Layout lay;
  if (!shape_ok(m, N, bl, nplanes, esize) || db < 0 || db >= m / bl ||
      !fill_layout(&lay, nbits, layout)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  return static_cast<int>(LILAC_DISPATCH(launch_bigshift, s0, s1, sstride, d0,
                                         d1, m, N, bl, masks, db, lay, cs));
}

// The current device's opt-in limit of dynamic shared memory per block.
extern "C" int lilac_hier_smem_optin(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
}
