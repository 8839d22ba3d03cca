// K9-K11: the adjoint passes of a gather network that ADD, for Hopper
// (sm_90a). They replace the Pallas kernels of lilac_tpu/kernels/routed.py:
//   K9  window_shift_apply_bt   (window pass, adjoint)
//   K10 bigshift_apply_bt       (block-aligned shift, adjoint)
//   K11 routed_apply_t          (single-table network, adjoint)
// (The adjoint passes that only exchange words, K7 and K8, are in hier.cu.)
//
// A forward stage copies with fan-out: y[i] <- m[i] ? y[partner(i)] : y[i].
// Its adjoint sums what the copies carried back:
//     u'[i] = (m[i] ? 0 : u[i]) + (m[j] ? u[j] : 0),
// where j is the slot whose forward partner is i: j = i + d for a `shift`
// stage (partner i - d) and j = i - d for a `shiftl` stage. An xor stage is
// an exchange and its own adjoint. A network's transpose runs its stages in
// reverse order with these updates (_stage_adj of the reference).
//
// The sum is taken at EVERY slot, also where both terms or one of them is
// the zero the mask put there: -0.0 + 0.0 is +0.0 and a df64 pair comes out
// renormalised, so a shortcut "nothing moved in: copy" would differ from
// the plain PyTorch version in the last bit. The stages are kept apart too:
// composing a window's stages into one scatter-add would sum in another
// order. One plane (f32, f64) or two independent planes add with one
// rounding; a df64 (hi, lo) pair (DF) adds by Knuth's TwoSum of the hi
// words and a renormalisation. Every step is an _rn intrinsic and the file
// is compiled --fmad=false, so nothing is contracted or reassociated.
//
// Bound: bytes, for all three (a handful of additions per slot moved).
// What the design does about it:
//   K9  keeps slots on chip: up to 8 dependent stages over the window
//       (block b, block b + 1). A stage reads upwards only (i and i + d),
//       so the C outputs of a span [c0, c0 + C) need input slots [c0, c0 +
//       C + sum(d)) of the window and their mask bytes, nothing else: a
//       thread block stages exactly that (16-byte cp.async; the right block
//       is read through the layout like block b, and sum(d) < bl keeps
//       cyclic wrap-around out of the span). C is a power of two from 128
//       to bl (window_bt_span in kernels/routed.py: 512 for class D's
//       shifts, 1024 for the general matrix's), C / 4 threads of 4
//       consecutive slots. Stage s (last to first) produces slots [0, C +
//       d[0] + .. + d[s-1]) of the span, reading one buffer and writing the
//       other: one barrier a stage; a thread reads its own 4 words and mask
//       bytes as vectors, those at i + d as the vectors around them, and
//       the few halo slots past C go one a thread. The span is stored as
//       one 16-byte vector a plane a thread. A thread block takes G spans
//       of one window block in turn (window_bt_spans: 16) and copies span
//       g + 1 into its second input slot while span g's stages run:
//       staging alone was bound by the copies a thread block has in flight
//       (class D, no stage: 0.373 ms one span a thread block, 0.227 with
//       G = 16, H100 80GB HBM3 at 700 W). The halo slots computed and
//       thrown away are sum(d) / C of the span. The first design (one
//       thread block a window block, 1024 threads, the window updated in
//       place in 9 chunks a stage with two barriers a chunk, 74 KB of
//       shared memory) took 0.541 ms at class D's shapes.
//   K10 is one merge of two blocks read through the layout.
//   K11 runs K1's passes (tile_pass.cuh) last to first, each pass's stages
//       backwards, with the merges above in place of the copies: a pass's
//       tile and halo sit in shared memory with its mask bytes, where the
//       first design sent every one of the 68 class-C stages through device
//       memory as a grid of its own. A shift's adjoint reads the other side
//       (i + d for `shift`), so its window's halo is on the other side from
//       the forward's; the merge is taken at every slot the window computes,
//       halo slots included, with the same intrinsics. The one-stage kernel
//       below is the pass for a stage with d >= T where m > T^2/4, as in K1.
//       The input is per net; it is never written.

#include <cuda_runtime.h>
#include <stdint.h>

#include <vector>

#include "tile_pass.cuh"

namespace {

using lilac_tiles::merge;
using lilac_tiles::Quad;

struct Layout {
  int nbits;
  unsigned char src[32];  // physical bit k <- logical bit src[k]
};

__device__ __forceinline__ long long phys_block(long long b, const Layout& l) {
  long long out = 0;
  for (int k = 0; k < l.nbits; ++k) {
    out |= ((b >> l.src[k]) & 1ll) << k;
  }
  return out;
}

// --------------------------------------------------------------- K9 window

struct Shifts {
  int n;
  int d[8];
  int pre[9];  // pre[s] = d[0] + .. + d[s-1]: stage s produces C + pre[s] slots
};

// words r .. r + 3 of the 8 in x, y (r = 1, 2, 3)
template <typename T>
__device__ __forceinline__ Quad<T> shifted(const Quad<T>& x, const Quad<T>& y, int r) {
  Quad<T> o;
  if (r == 1) {
    o.v[0] = x.v[1]; o.v[1] = x.v[2]; o.v[2] = x.v[3]; o.v[3] = y.v[0];
  } else if (r == 2) {
    o.v[0] = x.v[2]; o.v[1] = x.v[3]; o.v[2] = y.v[0]; o.v[3] = y.v[1];
  } else {
    o.v[0] = x.v[3]; o.v[1] = y.v[0]; o.v[2] = y.v[1]; o.v[3] = y.v[2];
  }
  return o;
}

// One stage of the adjoint over a span held in shared memory: slots [0,
// lim) of v from u, u' = (m[i] ? 0 : u[i]) + (m[i + d] ? u[i + d] : 0). The
// span's slots go 4 consecutive a thread, its own words and mask bytes as
// vectors and those at i + d as the vectors around them; the halo past the
// span (lim - span slots) one a thread.
template <typename T, int NP, bool DF>
__device__ __forceinline__ void window_stage(const T* u, T* v, const uint8_t* mk,
                                             int Wv, int span, int lim, int d, int s) {
  const int r = d & 3, d4 = d - r;
  for (int i = threadIdx.x * 4; i < span; i += blockDim.x * 4) {
    const uint32_t mw = *reinterpret_cast<const uint32_t*>(mk + i);
    uint32_t mjw = *reinterpret_cast<const uint32_t*>(mk + i + d4);
    if (r) {
      mjw = __funnelshift_r(mjw, *reinterpret_cast<const uint32_t*>(mk + i + d4 + 4),
                            8 * r);
    }
    Quad<T> a[NP], c[NP], o[NP];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      a[p] = *reinterpret_cast<const Quad<T>*>(u + p * Wv + i);
      const Quad<T> c0 = *reinterpret_cast<const Quad<T>*>(u + p * Wv + i + d4);
      c[p] = r ? shifted(c0, *reinterpret_cast<const Quad<T>*>(u + p * Wv + i + d4 + 4), r)
               : c0;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool mi = (mw >> (8 * j + s)) & 1u;
      const bool mj = (mjw >> (8 * j + s)) & 1u;
      T kept[NP], moved[NP], out[NP];
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        kept[p] = mi ? T(0) : a[p].v[j];
        moved[p] = mj ? c[p].v[j] : T(0);
      }
      merge<T, NP, DF>(kept, moved, out);
#pragma unroll
      for (int p = 0; p < NP; ++p) o[p].v[j] = out[p];
    }
#pragma unroll
    for (int p = 0; p < NP; ++p) *reinterpret_cast<Quad<T>*>(v + p * Wv + i) = o[p];
  }
  for (int i = span + threadIdx.x; i < lim; i += blockDim.x) {
    const bool mi = (mk[i] >> s) & 1;
    const bool mj = (mk[i + d] >> s) & 1;
    T kept[NP], moved[NP], out[NP];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      kept[p] = mi ? T(0) : u[p * Wv + i];
      moved[p] = mj ? u[p * Wv + i + d] : T(0);
    }
    merge<T, NP, DF>(kept, moved, out);
#pragma unroll
    for (int p = 0; p < NP; ++p) v[p * Wv + i] = out[p];
  }
}

// grid (nblocks * bl / (span * G), N), min(span / 4, 1024) threads: thread
// block x serves G consecutive spans of output slots of window block b, the
// g-th at c0 = (x * G % (bl / span) + g) * span. masks [N, nblocks, 2 * bl]
// bytes (16-byte aligned) as the forward pass reads them; the adjoint's
// window masks are the SECOND halves (a block's own switches) of blocks b
// and b + 1, bit s = stage s. Shared memory: input slots (two where G > 1,
// else one), each NP planes of Wv words (span + sum(d) rounded up to 4) and
// Wm mask bytes (rounded up to 32), then one more buffer of NP planes for
// the stages' ping-pong. The copies for span g + 1 are issued before span
// g's stages run.
template <typename T, int NP, bool DF>
__global__ void __launch_bounds__(1024)
    adj_window_kernel(const T* __restrict__ s0, const T* __restrict__ s1,
                      long long sstride, T* __restrict__ d0, T* __restrict__ d1,
                      long long m, int bl, const uint8_t* __restrict__ masks,
                      Shifts sh, int span, int G, int Wv, int Wm, Layout lay) {
  extern __shared__ __align__(32) unsigned char smem_raw[];
  const int slot_bytes = NP * Wv * sizeof(T) + Wm;
  T* const tmp = reinterpret_cast<T*>(smem_raw + (G > 1 ? 2 : 1) * slot_bytes);

  const int parts = bl / span;
  const long long first = static_cast<long long>(blockIdx.x) * G;
  const long long b = first / parts;
  const int k0 = static_cast<int>(first % parts);
  const long long n = blockIdx.y;
  const long long nblocks = gridDim.x * static_cast<long long>(G) / parts;
  const long long rb = (b + 1) % nblocks;  // the last block's right is block 0
  const long long self = n * sstride + phys_block(b, lay) * bl;
  const long long right = n * sstride + phys_block(rb, lay) * bl;
  const uint8_t* mself = masks + ((n * nblocks + b) * 2 + 1) * bl;
  const uint8_t* mright = masks + ((n * nblocks + rb) * 2 + 1) * bl;
  const T* srcs[2] = {s0, s1};
  T* dsts[2] = {d0, d1};

  // window positions [c0, c0 + Wv) of every plane and [c0, c0 + Wm) of the
  // masks into input slot q; a 16-byte copy never straddles slot bl
  auto stage_in = [&](int g, int q) {
    const int c0 = (k0 + g) * span;
    T* u = reinterpret_cast<T*>(smem_raw + q * slot_bytes);
    uint8_t* mk = smem_raw + q * slot_bytes + NP * Wv * sizeof(T);
    constexpr int kPer = 16 / sizeof(T);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      for (int i = threadIdx.x * kPer; i < Wv; i += blockDim.x * kPer) {
        const int w = c0 + i;
        lilac_tiles::copy16_async(u + p * Wv + i,
                                  srcs[p] + (w < bl ? self + w : right + (w - bl)));
      }
    }
    for (int i = threadIdx.x * 16; i < Wm; i += blockDim.x * 16) {
      const int w = c0 + i;
      lilac_tiles::copy16_async(mk + i, w < bl ? mself + w : mright + (w - bl));
    }
  };

  stage_in(0, 0);
  for (int g = 0; g < G; ++g) {
    // span g has landed in slot g % 2, and every thread is done with span
    // g - 1 (slot (g + 1) % 2 and tmp), so span g + 1 may be copied there
    lilac_tiles::copies_wait();
    __syncthreads();
    if (g + 1 < G) stage_in(g + 1, (g + 1) % 2);
    T* in = reinterpret_cast<T*>(smem_raw + (g % 2) * slot_bytes);
    const uint8_t* mk = smem_raw + (g % 2) * slot_bytes + NP * Wv * sizeof(T);
    T* bufs[2] = {in, tmp};
    int cur = 0;
    for (int s = sh.n - 1; s >= 0; --s) {
      // stage s produces span + pre[s] slots, reading up to span + pre[s + 1]
      window_stage<T, NP, DF>(bufs[cur], bufs[cur ^ 1], mk, Wv, span, span + sh.pre[s],
                              sh.d[s], s);
      __syncthreads();  // the stage is written: the next one reads it
      cur ^= 1;
    }
    const T* u = bufs[cur];
    const long long dst = n * m + b * bl + (k0 + g) * span;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      for (int i = threadIdx.x * 4; i < span; i += blockDim.x * 4) {
        *reinterpret_cast<Quad<T>*>(dsts[p] + dst + i) =
            *reinterpret_cast<const Quad<T>*>(u + p * Wv + i);
      }
    }
  }
}

// ------------------------------------------------------------ K10 bigshift

// grid (ceil(bl / (4 * threads)), nblocks, N). masks [N, nblocks, bl] bytes,
// non-zero = the forward took the word of block b - db: block b keeps its
// unmasked words and adds the masked words of block b + db.
template <typename T, int NP, bool DF>
__global__ void adj_bigshift_kernel(const T* __restrict__ s0,
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
  const long long rb = (b + db) % nblocks;
  const long long self = n * sstride + phys_block(b, lay) * bl + off;
  const long long right = n * sstride + phys_block(rb, lay) * bl + off;
  const long long dst = n * m + b * bl + off;
  const uint32_t ms =
      *reinterpret_cast<const uint32_t*>(masks + (n * nblocks + b) * bl + off);
  const uint32_t mr =
      *reinterpret_cast<const uint32_t*>(masks + (n * nblocks + rb) * bl + off);
  const T* srcs[2] = {s0, s1};
  T* dsts[2] = {d0, d1};
  Quad<T> a[NP], c[NP], o[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    a[p] = *reinterpret_cast<const Quad<T>*>(srcs[p] + self);
    c[p] = *reinterpret_cast<const Quad<T>*>(srcs[p] + right);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool mi = (ms >> (8 * j)) & 0xffu;
    const bool mj = (mr >> (8 * j)) & 0xffu;
    T kept[NP], moved[NP], out[NP];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      kept[p] = mi ? T(0) : a[p].v[j];
      moved[p] = mj ? c[p].v[j] : T(0);
    }
    merge<T, NP, DF>(kept, moved, out);
#pragma unroll
    for (int p = 0; p < NP; ++p) o[p].v[j] = out[p];
  }
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    *reinterpret_cast<Quad<T>*>(dsts[p] + dst) = o[p];
  }
}

// ------------------------------------------------------- K11 single table

using lilac_tiles::KIND_SHIFT;
using lilac_tiles::KIND_SHIFTL;
using lilac_tiles::KIND_XOR;
enum { KIND_COPY = 3 };

// One adjoint stage over all B nets of m slots; grid (ceil(m / (4 *
// threads)), B). mask points at the stage's byte plane of net 0, mstride
// bytes between nets; `kind` is the FORWARD stage's kind.
template <typename T, int NP, bool DF>
__global__ void adj_stage_kernel(const T* __restrict__ s0,
                                 const T* __restrict__ s1, T* __restrict__ d0,
                                 T* __restrict__ d1,
                                 const uint8_t* __restrict__ mask,
                                 long long mstride, int bit, int kind,
                                 long long d, long long m) {
  const long long i0 =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (i0 >= m) return;
  const long long b = blockIdx.y;
  const T* srcs[2] = {s0 + b * m, NP == 2 ? s1 + b * m : nullptr};
  T* dsts[2] = {d0 + b * m, NP == 2 ? d1 + b * m : nullptr};
  Quad<T> q[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    q[p] = *reinterpret_cast<const Quad<T>*>(srcs[p] + i0);
  }
  if (kind != KIND_COPY) {
    const uint8_t* mrow = mask + b * mstride;
    const uint32_t mw = *reinterpret_cast<const uint32_t*>(mrow + i0);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long i = i0 + j;
      const bool mi = (mw >> (8 * j + bit)) & 1u;
      if (kind == KIND_XOR) {
        if (mi) {
#pragma unroll
          for (int p = 0; p < NP; ++p) q[p].v[j] = srcs[p][i ^ d];
        }
      } else {
        const long long pj = (kind == KIND_SHIFT ? i + d : i - d) & (m - 1);
        const bool mj = (mrow[pj] >> bit) & 1;
        T kept[NP], moved[NP], out[NP];
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          kept[p] = mi ? T(0) : q[p].v[j];
          moved[p] = mj ? srcs[p][pj] : T(0);
        }
        merge<T, NP, DF>(kept, moved, out);
#pragma unroll
        for (int p = 0; p < NP; ++p) q[p].v[j] = out[p];
      }
    }
  }
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    *reinterpret_cast<Quad<T>*>(dsts[p] + i0) = q[p];
  }
}

// ------------------------------------------------------------- launchers

bool fill_layout(Layout* lay, int nbits, const unsigned char* src) {
  if (nbits < 0 || nbits > 32) return false;
  lay->nbits = nbits;
  for (int k = 0; k < 32; ++k) lay->src[k] = k < nbits ? src[k] : 0;
  return true;
}

int block_threads(int work) {
  int t = 1024;
  while (t > 32 && t > work) t >>= 1;
  return t;
}

// a kernel's dynamic shared memory limit (48 KB unless asked) raised once
// per device and size it has seen
struct SmemAllowed {
  size_t bytes[64] = {};
};

// shared memory of a K9 thread block (as kernels/routed.py:
// window_bt_smem_bytes): its input slots of NP planes and mask bytes, and
// one more buffer of NP planes
size_t window_smem(int span, int sumd, int nplanes, int esize, int G) {
  const int reach = span + sumd;
  const size_t words = static_cast<size_t>(nplanes) * esize * ((reach + 3) & ~3);
  const int slots = G > 1 ? 2 : 1;
  return (slots + 1) * words + slots * ((reach + 31) & ~31);
}

template <typename T, int NP, bool DF>
cudaError_t launch_window(const void* s0, const void* s1, long long sstride,
                          void* d0, void* d1, long long m, int N, int bl,
                          const void* masks, const Shifts& sh, int span, int G,
                          cudaStream_t stream, const Layout& lay) {
  static SmemAllowed allowed;
  const int reach = span + sh.pre[sh.n];
  const size_t smem = window_smem(span, sh.pre[sh.n], NP, sizeof(T), G);
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    size_t* seen = &allowed.bytes[dev & 63];
    if (smem > *seen) {
      err = cudaFuncSetAttribute(adj_window_kernel<T, NP, DF>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return err;
      *seen = smem;
    }
  }
  dim3 grid(static_cast<unsigned>(m / span / G), static_cast<unsigned>(N));
  const int threads = span / 4 < 1024 ? span / 4 : 1024;
  adj_window_kernel<T, NP, DF><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(s0), static_cast<const T*>(s1), sstride,
      static_cast<T*>(d0), static_cast<T*>(d1), m, bl,
      static_cast<const uint8_t*>(masks), sh, span, G, (reach + 3) & ~3,
      (reach + 31) & ~31, lay);
  return cudaGetLastError();
}

template <typename T, int NP, bool DF>
cudaError_t launch_bigshift(const void* s0, const void* s1, long long sstride,
                            void* d0, void* d1, long long m, int N, int bl,
                            const void* masks, long long db,
                            cudaStream_t stream, const Layout& lay) {
  const int threads = block_threads(bl / 4) > 256 ? 256 : block_threads(bl / 4);
  dim3 grid(static_cast<unsigned>((bl / 4 + threads - 1) / threads),
            static_cast<unsigned>(m / bl), static_cast<unsigned>(N));
  adj_bigshift_kernel<T, NP, DF><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(s0), static_cast<const T*>(s1), sstride,
      static_cast<T*>(d0), static_cast<T*>(d1), m, bl,
      static_cast<const uint8_t*>(masks), db, lay);
  return cudaGetLastError();
}

// Passes npass-1 .. 0, each pass's stages backwards. The input x is only
// read; the last launch (pass 0) must land in `out`, so the launches
// alternate backwards from it.
template <typename T, int NP, bool DF>
cudaError_t run_network_t(const void* x0, const void* x1, void* out0,
                          void* out1, void* tmp0, void* tmp1,
                          const uint8_t* masks, int B, int P, long long m,
                          int S, const int* kinds, const long long* dists,
                          int tile, int npass, const int* pkind,
                          const int* pstart, cudaStream_t stream) {
  const int threads = 256;
  dim3 grid(static_cast<unsigned>((m / 4 + threads - 1) / threads),
            static_cast<unsigned>(B));
  const T* s0 = static_cast<const T*>(x0);
  const T* s1 = static_cast<const T*>(x1);
  if (S == 0) {
    adj_stage_kernel<T, NP, DF><<<grid, threads, 0, stream>>>(
        s0, s1, static_cast<T*>(out0), static_cast<T*>(out1), masks, 0, 0,
        KIND_COPY, 0, m);
    return cudaGetLastError();
  }
  if (npass < 1 || npass > S) return cudaErrorInvalidValue;
  std::vector<lilac_tiles::TilePass> ps(npass);
  cudaError_t err = lilac_tiles::plan_passes(
      ps.data(), npass, pkind, pstart, S, kinds, dists, m, tile, true, NP,
      static_cast<int>(sizeof(T)));
  if (err != cudaSuccess) return err;
  const long long mstride = static_cast<long long>(P) * m;
  constexpr int mode = DF ? lilac_tiles::MODE_ADJ_DF : lilac_tiles::MODE_ADJ;
  for (int q = npass - 1; q >= 0; --q) {
    const bool to_out = (q % 2) == 0;
    T* d0 = static_cast<T*>(to_out ? out0 : tmp0);
    T* d1 = static_cast<T*>(to_out ? out1 : tmp1);
    if (ps[q].n == 0) {
      const int s = pstart[q];
      adj_stage_kernel<T, NP, DF><<<grid, threads, 0, stream>>>(
          s0, s1, d0, d1, masks + static_cast<long long>(s / 8) * m, mstride,
          s % 8, kinds[s], dists[s], m);
      err = cudaGetLastError();
    } else {
      err = lilac_tiles::launch_tile_pass<T, NP, mode>(
          ps[q], s0, s1, m, d0, d1, masks, mstride, m, B, stream);
    }
    if (err != cudaSuccess) return err;
    s0 = d0;
    s1 = d1;
  }
  return cudaSuccess;
}

bool shape_ok(long long m, int N, int bl, int nplanes, int esize) {
  if (bl < 128 || (bl & (bl - 1)) != 0 || m < bl || (m & (m - 1)) != 0) return false;
  if (m / bl > 65535 || N < 1 || N > 65535) return false;
  return (nplanes == 1 || nplanes == 2) && (esize == 4 || esize == 8);
}

}  // namespace

// words of esize 4 are float, of esize 8 double; dfpair counts only with two
// planes (one plane has no lo word to compensate into)
#define LILAC_ADJ_PLANES(FN, T, ...)                                          \
  (nplanes == 1 ? FN<T, 1, false>(__VA_ARGS__)                                \
                : (dfpair ? FN<T, 2, true>(__VA_ARGS__)                       \
                          : FN<T, 2, false>(__VA_ARGS__)))
#define LILAC_ADJ_DISPATCH(FN, ...)                                           \
  (esize == 4 ? LILAC_ADJ_PLANES(FN, float, __VA_ARGS__)                      \
              : LILAC_ADJ_PLANES(FN, double, __VA_ARGS__))

// Common arguments as in hier.cu: s0/s1 input planes (s1 unused when
// nplanes == 1) with `sstride` words between nets, d0/d1 output planes
// [N, m], masks in the forward pass's layout, layout[nbits] the block-bit
// permutation of the input. Every function returns the cudaError_t of its
// launch.

// span: output slots a thread block takes at a time, a power of two from
// 128 to bl; G: spans a thread block takes in turn, a power of two up to
// bl / span; masks 16-byte aligned.
extern "C" int lilac_adj_window(const void* s0, const void* s1, int nplanes,
                                int esize, long long sstride, void* d0,
                                void* d1, long long m, int N, int bl,
                                const void* masks, int dfpair, int S,
                                const int* dists, int nbits,
                                const unsigned char* layout, int span, int G,
                                void* stream) {
  Shifts sh;
  Layout lay;
  if (!shape_ok(m, N, bl, nplanes, esize) || S < 0 || S > 8 ||
      !fill_layout(&lay, nbits, layout) || span < 128 || span > bl ||
      (span & (span - 1)) != 0 || G < 1 || (G & (G - 1)) != 0 || G > bl / span ||
      reinterpret_cast<uintptr_t>(masks) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  sh.n = S;
  sh.pre[0] = 0;
  for (int s = 0; s < 8; ++s) {
    sh.d[s] = s < S ? dists[s] : 0;
    if (s < S && dists[s] < 1) return static_cast<int>(cudaErrorInvalidValue);
    sh.pre[s + 1] = sh.pre[s] + sh.d[s];
  }
  if (sh.pre[S] >= bl) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  return static_cast<int>(LILAC_ADJ_DISPATCH(launch_window, s0, s1, sstride, d0,
                                             d1, m, N, bl, masks, sh, span, G,
                                             cs, lay));
}

extern "C" int lilac_adj_bigshift(const void* s0, const void* s1, int nplanes,
                                  int esize, long long sstride, void* d0,
                                  void* d1, long long m, int N, int bl,
                                  const void* masks, int dfpair, long long db,
                                  int nbits, const unsigned char* layout,
                                  void* stream) {
  Layout lay;
  if (!shape_ok(m, N, bl, nplanes, esize) || db < 0 || db >= m / bl ||
      !fill_layout(&lay, nbits, layout)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  return static_cast<int>(LILAC_ADJ_DISPATCH(launch_bigshift, s0, s1, sstride,
                                             d0, d1, m, N, bl, masks, db, cs,
                                             lay));
}

// x0/x1: input planes [B, m] (x1 unused when nplanes == 1), only read.
// out0/out1, tmp0/tmp1: [B, m] words each; the result is in out.
// masks: [B, P, m] bytes. kinds/dists: host arrays of S entries, the
// forward network's, in its order; tile / pkind / pstart: its passes, as
// K1 takes them (lilac_routed_apply).
extern "C" int lilac_adj_routed(const void* x0, const void* x1, int nplanes,
                                int esize, int dfpair, void* out0, void* out1,
                                void* tmp0, void* tmp1, const void* masks,
                                int B, int P, long long m, int S,
                                const int* kinds, const long long* dists,
                                int tile, int npass, const int* pkind,
                                const int* pstart, void* stream) {
  if (m < 1024 || (m & (m - 1)) != 0 || B < 1 || B > 65535 || S < 0 ||
      (S > 0 && P != (S + 7) / 8) || (nplanes != 1 && nplanes != 2) ||
      (esize != 4 && esize != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int s = 0; s < S; ++s) {
    if (kinds[s] < KIND_XOR || kinds[s] > KIND_SHIFTL || dists[s] < 1 ||
        dists[s] >= m) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const uint8_t* mk = static_cast<const uint8_t*>(masks);
  return static_cast<int>(LILAC_ADJ_DISPATCH(run_network_t, x0, x1, out0, out1,
                                             tmp0, tmp1, mk, B, P, m, S, kinds,
                                             dists, tile, npass, pkind, pstart,
                                             cs));
}
