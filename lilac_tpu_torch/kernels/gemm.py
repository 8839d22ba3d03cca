"""Dense C = A·Bᵀ in float32 (kernel K12), Parboil sgemm's product.

Counterpart of lilac_tpu/kernels/pallas_gemm.py. `matmul_nt(a, bt)` takes
A [M, K] and Bᵀ [N, K] (Parboil's "NT" layout) and, for tensors on the
card, launches the two hand-written CUDA grids of csrc/gemm.cu on the
tensor cores:

* `split_bf16x3` writes each operand as three bf16 pieces, x = x0 + x1 + x2
  exactly (x0 = bf16(x), x1 = bf16(x - x0), x2 = x - x0 - x1), rows padded
  with zeros to `padded_k(K)`, from operands of any strides and alignment;
* `gemm_bf16x3` sums the eight largest products of the pieces a term (all
  but a2·b2) with TMA loads and wgmma, a0·b0 and the seven cross terms in
  two f32 accumulators, and writes their sum. The tensor cores' own f32
  sums round toward zero (`chip_smoke.py gemm_diag`), by less than an
  eighth of what the bound allows.

Every element stays within K·2^-24·(|A||B|ᵀ) + 2^-24·|C| of the exact
product, the bound an f32 sum of K products owes, for finite operands
whose nonzero elements are at least 2^-110 in magnitude, where the
products and C stay in f32's normal range (below it any f32 result owes
an absolute 2^-150 more). Under 2^-110 the last piece falls among bf16's
subnormals and keeps only multiples of 2^-133, so an element may miss the
bound by up to 2^-134·|b| a term of such an a (and the same for b).
Operands up to f32's largest value are split exactly: above bf16's
largest finite value (3.3895e38) x0 is rounded toward zero instead of to
infinity. An infinite or NaN operand makes the elements it enters NaN.
The split runs on every call: nothing is cached across calls. K = 0
gives zeros.

`matmul_nt_plain` is the f64 oracle, (A·Bᵀ in float64) rounded to f32;
it is what a CPU tensor gets. `matmul_nt_torch` is the counterpart of the
reference's `matmul_nt_xla`: one `torch.matmul` with TF32 off, an option
of the sgemm workload, never its default.
"""

from __future__ import annotations

import ctypes

import torch

from lilac_tpu_torch.kernels import _cuda

KPAD = 32  # the pieces' rows are padded to a multiple of this: BK of csrc/gemm.cu
BF16_MAX = torch.finfo(torch.bfloat16).max  # 3.3895e38
_MAX_M = 65535 * 128  # grid.y of the GEMM, one tile row of 128
_MAX_DIM = 2 ** 31 - KPAD  # TMA coordinates and the split's indices are int32


def _check(a: torch.Tensor, bt: torch.Tensor):
    if a.dim() != 2 or bt.dim() != 2 or a.shape[1] != bt.shape[1]:
        raise ValueError(
            f"matmul_nt takes A [M, K] and Bt [N, K], got {tuple(a.shape)} and "
            f"{tuple(bt.shape)}")
    if a.dtype != torch.float32 or bt.dtype != torch.float32 or a.device != bt.device:
        raise ValueError(
            f"matmul_nt takes float32 operands on one device, got {a.dtype} on "
            f"{a.device} and {bt.dtype} on {bt.device}")
    return a.shape[0], bt.shape[0], a.shape[1]


def padded_k(K: int) -> int:
    """Row length of the piece planes: K rounded up to KPAD (at least KPAD,
    so that K = 0 still runs one tile of zeros)."""
    if K < 0:
        raise ValueError(f"K = {K}")
    return max(KPAD, -(-K // KPAD) * KPAD)


def matmul_nt_plain(a: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """The f64 oracle: (A·Bᵀ computed in float64) rounded to float32."""
    _check(a, bt)
    return (a.double() @ bt.double().T).float()


def matmul_nt_torch(a: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """One torch.matmul in full float32 (TF32 off for the call)."""
    _check(a, bt)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.matmul(a, bt.T)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _split_args(xs):
    if not 1 <= len(xs) <= 2:
        raise ValueError("split_bf16x3 takes one or two operands")
    K = xs[0].shape[1] if xs[0].dim() == 2 else -1
    for x in xs:
        if x.dim() != 2 or x.shape[1] != K or x.dtype != torch.float32 or (
                x.device != xs[0].device):
            raise ValueError(
                "split_bf16x3 takes float32 [rows, K] operands of one K on one "
                f"device, got {[(tuple(x.shape), x.dtype, str(x.device)) for x in xs]}")
    return K, padded_k(K)


def split_bf16x3_plain(*xs: torch.Tensor):
    """Plain version of split_bf16x3: per operand [3, rows, padded_k(K)]
    bf16 pieces x0 = bf16_rn(x), x1 = bf16_rn(x - x0), x2 = bf16_rn(x - x0 -
    x1), the differences in f32 (exact), columns K.. zero. Where |x| is
    above bf16's largest finite value, x0 is rounded toward zero (the top
    16 bits of x) instead of to infinity."""
    K, kp = _split_args(xs)
    outs = []
    for x in xs:
        cut = (x.contiguous().view(torch.int32) & -65536).view(torch.float32)
        p0 = torch.where(x.abs() > BF16_MAX, cut, x).to(torch.bfloat16)
        r1 = x - p0.float()
        p1 = r1.to(torch.bfloat16)
        p2 = (r1 - p1.float()).to(torch.bfloat16)
        out = torch.zeros((3, x.shape[0], kp), dtype=torch.bfloat16, device=x.device)
        out[:, :, :K] = torch.stack((p0, p1, p2))
        outs.append(out)
    return tuple(outs)


def _lib():
    lib = _cuda.load("gemm")
    if not getattr(lib, "_typed", False):
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.lilac_split_bf16x3.argtypes = [vp, ll, ll, ll, vp, vp, ll, ll, ll, vp,
                                           ci, ci, vp]
        lib.lilac_gemm_bf16x3.argtypes = [vp, vp, vp, ci, ci, ci, vp]
        lib.lilac_gemm_attrs.argtypes = [ctypes.POINTER(ci)]
        for fn in (lib.lilac_split_bf16x3, lib.lilac_gemm_bf16x3, lib.lilac_gemm_attrs):
            fn.restype = ci
        lib._typed = True
    return lib


def split_bf16x3(*xs: torch.Tensor):
    """Split one or two f32 operands [rows, K] (any strides) into bf16
    pieces [3, rows, padded_k(K)], one grid for both. CUDA tensors take the
    kernel of csrc/gemm.cu, CPU tensors the plain version."""
    if not xs[0].is_cuda:
        return split_bf16x3_plain(*xs)
    K, kp = _split_args(xs)
    if max(x.shape[0] for x in xs) > _MAX_DIM or K > _MAX_DIM:
        raise ValueError(f"split_bf16x3: {[tuple(x.shape) for x in xs]} exceeds int32")
    outs = [torch.empty((3, x.shape[0], kp), dtype=torch.bfloat16, device=x.device)
            for x in xs]
    ops = [(x.data_ptr(), x.shape[0], x.stride(0), x.stride(1), o.data_ptr())
           for x, o in zip(xs, outs)]
    if len(ops) == 1:
        ops.append((None, 0, 0, 0, None))
    with torch.cuda.device(xs[0].device):
        err = _lib().lilac_split_bf16x3(*ops[0], *ops[1], K, kp,
                                        torch.cuda.current_stream().cuda_stream)
    _cuda.check(err, "split_bf16x3")
    split_bf16x3.launches += 1
    return tuple(outs)


def _check_pieces(pa: torch.Tensor, pb: torch.Tensor):
    for p in (pa, pb):
        if (p.dim() != 3 or p.shape[0] != 3 or p.dtype != torch.bfloat16
                or p.shape[2] != pa.shape[2] or p.shape[2] % KPAD or p.shape[2] == 0
                or p.device != pa.device):
            raise ValueError(
                "gemm_bf16x3 takes bf16 pieces [3, rows, kp] of one kp (a multiple "
                f"of {KPAD}) on one device, got {tuple(pa.shape)} {pa.dtype} and "
                f"{tuple(pb.shape)} {pb.dtype}")
    return pa.shape[1], pb.shape[1], pa.shape[2]


def gemm_bf16x3_plain(pa: torch.Tensor, pb: torch.Tensor) -> torch.Tensor:
    """Plain version of gemm_bf16x3: the f64 product of the operands the
    pieces sum to, rounded to f32 (the kernel also drops a2·b2 and rounds
    in f32, within matmul_nt's bound of this)."""
    _check_pieces(pa, pb)
    a = pa.double().sum(dim=0)
    b = pb.double().sum(dim=0)
    return (a @ b.T).float()


def gemm_bf16x3(pa: torch.Tensor, pb: torch.Tensor) -> torch.Tensor:
    """C [M, N] f32 from the pieces of A (pa [3, M, kp]) and Bt (pb [3, N,
    kp]), as split_bf16x3 writes them: one grid on the tensor cores. CUDA
    tensors take the kernel, CPU tensors the plain version."""
    if not pa.is_cuda:
        return gemm_bf16x3_plain(pa, pb)
    M, N, kp = _check_pieces(pa, pb)
    if M > _MAX_M or N > _MAX_DIM or kp > _MAX_DIM:
        raise ValueError(f"gemm_bf16x3: shape {(M, N, kp)} exceeds the kernel's grid")
    if not (pa.is_contiguous() and pb.is_contiguous()):
        raise ValueError("gemm_bf16x3: the pieces must be contiguous")
    c = torch.empty((M, N), dtype=torch.float32, device=pa.device)
    with torch.cuda.device(pa.device):
        err = _lib().lilac_gemm_bf16x3(pa.data_ptr(), pb.data_ptr(), c.data_ptr(), M, N,
                                       kp, torch.cuda.current_stream().cuda_stream)
    _cuda.check(err, "gemm_bf16x3")
    gemm_bf16x3.launches += 1
    return c


def gemm_launch_config(M: int, N: int, K: int, *, device="cuda") -> dict:
    """How one matmul_nt call launches, as the runtime reports it: its two
    grids, and the GEMM's threads, shared memory, registers a thread at
    entry, spilled bytes, blocks resident on one SM and ring of stages."""
    out = (ctypes.c_int * 9)()
    with torch.cuda.device(torch.device(device)):
        _cuda.check(_lib().lilac_gemm_attrs(out), "gemm_launch_config")
    threads, smem, regs, local, ctas, stages, bm, bn, bk = out
    kp = padded_k(K)
    return {"grids_per_call": 2,
            "split": {"grid": [-(-(M + N) * (kp // 8) // 256)], "threads": 256},
            "gemm": {"grid": [-(-N // bn), -(-M // bm)], "threads": threads,
                     "smem_bytes": smem, "regs": regs, "local_bytes": local,
                     "ctas_per_sm": ctas, "stages": stages, "tile": [bm, bn, bk]},
            "kp": kp}


def matmul_nt(a: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """C = a @ bt.T with a [M, K], bt [N, K], float32 (kernel K12).

    CUDA tensors go through split_bf16x3 and gemm_bf16x3 on the current
    stream (operands of any strides and alignment, no copy); a launch error
    raises. Only CPU tensors take the plain version."""
    if not a.is_cuda:
        return matmul_nt_plain(a, bt)
    M, N, K = _check(a, bt)
    if M > _MAX_M or max(N, K) > _MAX_DIM:
        raise ValueError(f"matmul_nt: shape {(M, N, K)} exceeds the kernel's grid")
    if M == 0 or N == 0:
        return torch.empty((M, N), dtype=torch.float32, device=a.device)
    c = gemm_bf16x3(*split_bf16x3(a, bt))
    matmul_nt.launches += 1
    return c


# calls that launched the kernels: matmul_nt (both grids), and each grid's
# own wrapper
matmul_nt.launches = 0
split_bf16x3.launches = 0
gemm_bf16x3.launches = 0
