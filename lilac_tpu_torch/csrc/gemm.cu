// K12: matmul_nt for Hopper (sm_90a). Replaces the Pallas kernel
// lilac_tpu/kernels/pallas_gemm.py:_kernel / matmul_nt (the pl.pallas_call
// at :46), Parboil sgemm's product.
//
// Computes C = A * Bt^T with A [M, K], Bt [N, K] and C [M, N], float32
// (Parboil's "NT" layout: both operands K-contiguous), on the tensor cores,
// and keeps every element within K * 2^-24 * sum_k |a_ik b_jk| + 2^-24 |c_ij|
// of the exact product, the bound an f32 sum of K products owes.
//
// Arithmetic: an exact three-piece bf16 split. Every f32 a is the sum of
// three bf16 pieces, a = a0 + a1 + a2, a0 = bf16_rn(a), a1 = bf16_rn(a - a0),
// a2 = a - a0 - a1 (8 + 8 + 8 significant bits hold f32's 24; each
// difference is exact in f32 by Sterbenz, and a2 is exact in bf16 unless
// |a| < 2^-110, where it may fall among bf16's subnormals). Above bf16's
// largest finite value (3.3895e38, up to f32's 3.4028e38) bf16_rn would
// give infinity, so a0 is rounded toward zero there instead: a0 <= |a| <=
// 2 a0 keeps a - a0 exact, and a1, a2 follow as before. A product of two
// bf16 pieces is exact in f32, so
//   a.b = a0b0 + (a0b1 + a1b0 + a1b1 + a0b2 + a2b0 + a1b2 + a2b1) + a2b2,
// and dropping a2b2 (< 2^-34 |a||b|) leaves 8 tensor-core products a term.
// a0b0 goes to one accumulator (acc_hi), the seven cross terms, all at
// most 2^-8 of it (2^-7 where a0 was rounded toward zero), to another
// (acc_lo), so acc_lo's rounding is scaled by 2^-8; the epilogue writes
// __fadd_rn(acc_hi, acc_lo). TF32 (10 stored
// bits) cannot do this with two pieces: the low piece of a needs up to 13
// bits, and at K = 1 the dropped part alone breaks the bound.
//
// Two grids a call:
//  (a) split_bf16x3: reads A and Bt once (any strides) and writes each as
//      three bf16 planes [3, rows, Kp], rows padded with zeros to Kp, a
//      multiple of BK = 32: 64-byte rows that TMA takes whatever the
//      operands' alignment, and whole K tiles for the GEMM.
//  (b) gemm_bf16x3: one 128 x 128 tile of C per thread block of 384 threads:
//      a producer warpgroup whose first thread starts the TMA loads of the
//      piece tiles (all three pieces of A's and of Bt's tile, one 3-D box
//      each) into a ring of 4 stages in shared memory (48 KB a stage, 192 KB
//      in all), and two consumer warpgroups of 64 rows each running
//      wgmma.m64n128k16.f32.bf16.bf16, both operands K-major from
//      64-byte-swizzled tiles (BK = 32 bf16, a row of a tile is one swizzle
//      row; BK = 64 with 128-byte swizzle leaves room for 2 stages only and
//      took 1.575 ms against 1.297 at 4096^3 on an H100 80GB HBM3 at 700 W).
//      Per 16-wide K step a consumer runs 8 wgmma: a0b0 into acc_hi, the 7
//      cross terms into acc_lo (64 + 64 f32 registers a thread). Full /
//      empty mbarriers pace the ring; a consumer keeps one stage's wgmma
//      group in flight while it waits for the next. setmaxnreg gives the
//      consumers 232 registers and the producer 40. The M and N edges load
//      zeros (TMA's out-of-range fill) and the stores are masked.
//
// The tensor cores' f32 accumulation rounds toward zero, in a K step of 16
// products and from one step to the next (measured: chip_smoke.py
// gemm_diag), less than one ulp of the largest magnitude in the step. Over
// K / 16 steps that is at most K * 2^-27 * sum_k |a_ik b_jk|, an eighth of
// the bound, so acc_hi is never promoted into a CUDA-core sum.
//
// Bound: operations. 8 * 2MNK bf16 tensor-core flops over 989 TFLOP/s
// (1.112 ms at 4096^3); bytes 4 (MK + NK + MN) for the function, plus the
// split's own traffic (read 4 (MK + NK), write 6 (M + N) Kp).
//
// Every source of the port builds with --fmad=false; the split and the
// epilogue use the _rn intrinsics, so nothing depends on that flag here.

#include <cuda.h>  // CUtensorMap and the encoder's types (no libcuda link)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;    // rows of A in a tile: 2 consumer warpgroups x 64
constexpr int BN = 128;    // rows of Bt in a tile (the wgmma's N)
constexpr int CONSUMERS = 2;
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
static_assert(PRODUCER_REGS * 128 + CONSUMER_REGS * 128 * CONSUMERS <= 65536,
              "register budget of one block");
// bf16 along K a stage: one 64-byte swizzle row. The piece planes' rows are
// padded to a multiple of it (KPAD in kernels/gemm.py, which must equal it;
// lilac_gemm_attrs reports it).
constexpr int BK = 32;
constexpr int PIECE_A = BM * BK * 2;  // bytes of one piece's tile
constexpr int PIECE_B = BN * BK * 2;
constexpr int STAGE = 3 * (PIECE_A + PIECE_B);
constexpr int STAGES = 4;
constexpr int SMEM = STAGES * STAGE + 1024 + 2 * STAGES * 8;  // + alignment, barriers

// ------------------------------------------------------------- split

struct Operand {
  const float* x;
  long long rows, sr, sc;  // element strides of a row and of a column
  __nv_bfloat16* out;      // [3, rows, Kp]
  int vec;                 // sc == 1, 16-byte aligned rows, K % 4 == 0
};

constexpr float kBf16Max = 3.38953139e38f;  // bf16's largest finite value

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// One thread: 8 consecutive k of one row of A (rows [0, a.rows)) or of Bt
// (the rows after), three 16-byte stores.
__global__ void __launch_bounds__(256)
    split_bf16x3_kernel(Operand a, Operand b, int K, int Kp) {
  const long long chunks = Kp / 8;
  const long long item = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  long long r = item / chunks;
  const int k0 = static_cast<int>(item - r * chunks) * 8;
  const bool is_a = r < a.rows;
  if (!is_a) r -= a.rows;
  const long long rows = is_a ? a.rows : b.rows;
  if (r >= rows) return;
  const float* x = is_a ? a.x : b.x;
  const long long sr = is_a ? a.sr : b.sr;
  const long long sc = is_a ? a.sc : b.sc;
  __nv_bfloat16* out = is_a ? a.out : b.out;
  const int vec = is_a ? a.vec : b.vec;
  float v[8];
  const float* row = x + r * sr;
  if (vec) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + 4 * h < K) t = __ldg(reinterpret_cast<const float4*>(row + k0 + 4 * h));
      v[4 * h] = t.x;
      v[4 * h + 1] = t.y;
      v[4 * h + 2] = t.z;
      v[4 * h + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = k0 + j < K ? __ldg(row + (k0 + j) * sc) : 0.0f;
  }
  uint32_t w[3][4];
#pragma unroll
  for (int j = 0; j < 8; j += 2) {
    __nv_bfloat16 p[3][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float x0 = v[j + h];
      // toward zero above bf16's largest finite value, where _rn overflows
      p[0][h] = fabsf(x0) > kBf16Max ? __float2bfloat16_rz(x0) : __float2bfloat16_rn(x0);
      const float r1 = __fsub_rn(x0, __bfloat162float(p[0][h]));
      p[1][h] = __float2bfloat16_rn(r1);
      p[2][h] = __float2bfloat16_rn(__fsub_rn(r1, __bfloat162float(p[1][h])));
    }
#pragma unroll
    for (int q = 0; q < 3; ++q) w[q][j / 2] = pack2(p[q][0], p[q][1]);
  }
  const long long plane = rows * Kp;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    *reinterpret_cast<uint4*>(out + q * plane + r * Kp + k0) =
        make_uint4(w[q][0], w[q][1], w[q][2], w[q][3]);
  }
}

// ------------------------------------------------------------- PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Waits for the completion of the barrier's phase of parity `parity`. A wait
// that lasts 10 s traps (the launch then fails) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  uint64_t t0 = 0;
  for (;;) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    uint64_t t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (t0 == 0) {
      t0 = t;
    } else if (t - t0 > 10000000000ull) {
      __trap();
    }
  }
}

// One 3-D box {BK, rows, 3} of a piece-plane tensor map into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k), "r"(row), "r"(0)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major bf16 tile whose rows of BK
// are one 64-byte swizzle row each: start address, leading offset 16 B
// (unused when the K step lies in one swizzle row), 512 B between groups
// of 8 rows, layout B64.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  constexpr uint64_t sbo = (8 * BK * 2) >> 4;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (sbo << 32) |
         (2ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (it sees the registers read and written here).
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A (64 x 16, K-major) * B (128 x 16, K-major)^T, f32 accumulation.
__device__ __forceinline__ void wgmma128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// ------------------------------------------------------------- the GEMM

// grid (ceil(N / BN), ceil(M / BM)). ma / mb: 3-D tensor maps {Kp, rows, 3}
// of the piece planes of A and Bt, box {BK, 128, 3}, 64-byte swizzle.
__global__ void __launch_bounds__(THREADS, 1)
    gemm_bf16x3_kernel(const __grid_constant__ CUtensorMap ma,
                       const __grid_constant__ CUtensorMap mb,
                       float* __restrict__ c, int M, int N, int nk) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = base + STAGES * STAGE;  // full[STAGES], empty[STAGES]
  const int wg = threadIdx.x / 128;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (STAGES + s), 128 * CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        const uint32_t ph = (kt / STAGES) & 1;
        mbar_wait(bars + 8 * (STAGES + s), ph ^ 1);
        const uint32_t full = bars + 8 * s;
        mbar_expect_tx(full, STAGE);
        const uint32_t sa = base + s * STAGE;
        tma_load(sa, &ma, full, kt * BK, m0);
        tma_load(sa + 3 * PIECE_A, &mb, full, kt * BK, n0);
      }
    }
  } else {  // consumers: 64 rows of the tile each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    const int wc = wg - 1;
    float hi[64], lo[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      hi[i] = 0.0f;
      lo[i] = 0.0f;
    }
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % STAGES;
      mbar_wait(bars + 8 * s, (kt / STAGES) & 1);
      const uint32_t sa = base + s * STAGE + wc * 64 * BK * 2;
      const uint32_t sb = base + s * STAGE + 3 * PIECE_A;
      fence_acc(hi);
      fence_acc(lo);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint64_t da[3], db[3];
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          da[q] = smem_desc(sa + q * PIECE_A + kk * 32);
          db[q] = smem_desc(sb + q * PIECE_B + kk * 32);
        }
        wgmma128(hi, da[0], db[0]);
        wgmma128(lo, da[0], db[1]);
        wgmma128(lo, da[1], db[0]);
        wgmma128(lo, da[1], db[1]);
        wgmma128(lo, da[0], db[2]);
        wgmma128(lo, da[2], db[0]);
        wgmma128(lo, da[1], db[2]);
        wgmma128(lo, da[2], db[1]);
      }
      wgmma_commit();
      fence_acc(hi);
      fence_acc(lo);
      wgmma_wait<1>();  // the previous stage's products are done
      if (kt > 0) mbar_arrive(bars + 8 * (STAGES + (kt - 1) % STAGES));
    }
    wgmma_wait<0>();
    fence_acc(hi);
    fence_acc(lo);
    // accumulator layout of m64nNk16: register 4j + 2h + e of a thread holds
    // row 16 warp + lane / 4 + 8 h, column 8 j + 2 (lane % 4) + e
    const int lane = threadIdx.x % 32;
    const int warp = (threadIdx.x / 32) % 4;
    const int row0 = m0 + wc * 64 + warp * 16 + lane / 4;
    const bool pairs = (N % 2) == 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + 8 * j + 2 * (lane % 4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row >= M || col >= N) continue;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          v[e] = __fadd_rn(hi[i], lo[i]);
        }
        float* dst = c + static_cast<long long>(row) * N + col;
        if (pairs) {  // col even and col + 1 < N: an aligned pair
          *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
        } else {
          dst[0] = v[0];
          if (col + 1 < N) dst[1] = v[1];
        }
      }
    }
  }
}

// ------------------------------------------------------------- host side

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, which this library does not
// link, so it is fetched through the runtime once.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// {Kp, rows, 3} bf16 planes, box {BK, 128, 3}, zeros past the rows
bool piece_map(CUtensorMap* map, const void* planes, long long rows, long long Kp) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(Kp),
                              static_cast<cuuint64_t>(rows), 3};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(Kp) * 2,
                                 static_cast<cuuint64_t>(rows * Kp) * 2};
  const cuuint32_t box[3] = {BK, 128, 3};
  const cuuint32_t estr[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(planes),
             dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Raises the kernel's shared memory limit (once a device) and reads its
// attributes; refuses a register count at entry from which setmaxnreg
// could not give the consumers their registers (they would wait forever).
cudaError_t gemm_ready(cudaFuncAttributes* fa) {
  static int seen[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (!seen[dev & 63]) {
    err = cudaFuncSetAttribute(gemm_bf16x3_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return err;
    seen[dev & 63] = 1;
  }
  err = cudaFuncGetAttributes(fa, gemm_bf16x3_kernel);
  if (err != cudaSuccess) return err;
  if ((fa->numRegs - PRODUCER_REGS) * 128 <
      (CONSUMER_REGS - fa->numRegs) * 128 * CONSUMERS) {
    return cudaErrorInvalidConfiguration;
  }
  return cudaSuccess;
}

}  // namespace

// Writes A [M, K] (element strides sam, sak) and Bt [N, K] (sbn, sbk) as
// bf16 pieces pa [3, M, Kp] and pb [3, N, Kp], Kp a multiple of BK >= K, in
// one grid. pa, pb 16-byte aligned. N = 0 splits A alone.
extern "C" int lilac_split_bf16x3(const float* a, long long M, long long sam,
                                  long long sak, void* pa, const float* bt,
                                  long long N, long long sbn, long long sbk,
                                  void* pb, int K, int Kp, void* stream) {
  if (M < 0 || N < 0 || K < 0 || Kp < K || Kp % BK != 0 ||
      reinterpret_cast<uintptr_t>(pa) % 16 != 0 ||
      (N > 0 && reinterpret_cast<uintptr_t>(pb) % 16 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long items = (M + N) * (Kp / 8);
  if (items == 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (items + 255) / 256;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  auto vec = [K](const float* x, long long sr, long long sc) {
    return static_cast<int>(sc == 1 && sr % 4 == 0 && K % 4 == 0 &&
                            reinterpret_cast<uintptr_t>(x) % 16 == 0);
  };
  Operand oa{a, M, sam, sak, static_cast<__nv_bfloat16*>(pa), vec(a, sam, sak)};
  Operand ob{bt, N, sbn, sbk, static_cast<__nv_bfloat16*>(pb), vec(bt, sbn, sbk)};
  split_bf16x3_kernel<<<static_cast<unsigned>(blocks), 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(oa, ob, K, Kp);
  return static_cast<int>(cudaGetLastError());
}

// C [M, N] (row-major, 8-byte aligned) = the sum of the pieces' products of
// pa [3, M, Kp] and pb [3, N, Kp] (lilac_split_bf16x3's planes).
extern "C" int lilac_gemm_bf16x3(const void* pa, const void* pb, float* c, int M,
                                 int N, int Kp, void* stream) {
  if (M <= 0 || N <= 0 || Kp <= 0 || Kp % BK != 0 || (M + BM - 1) / BM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaFuncAttributes fa;
  cudaError_t err = gemm_ready(&fa);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap ma, mb;
  if (!piece_map(&ma, pa, M, Kp) || !piece_map(&mb, pb, N, Kp)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_bf16x3_kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      ma, mb, c, M, N, Kp / BK);
  return static_cast<int>(cudaGetLastError());
}

// How the GEMM launches, for reports: out = {threads, dynamic shared memory
// bytes, registers a thread at entry, local (spilled) bytes, blocks
// resident on one SM, stages, BM, BN, BK}.
extern "C" int lilac_gemm_attrs(int* out) {
  cudaFuncAttributes fa;
  int ctas = 0;
  cudaError_t err = gemm_ready(&fa);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, gemm_bf16x3_kernel,
                                                      THREADS, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vals[9] = {THREADS, SMEM, fa.numRegs, static_cast<int>(fa.localSizeBytes),
                       ctas, STAGES, BM, BN, BK};
  for (int i = 0; i < 9; ++i) out[i] = vals[i];
  return static_cast<int>(cudaSuccess);
}
