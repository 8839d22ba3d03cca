"""Dense C = A·Bᵀ in float32 (kernel K12), Parboil sgemm's product.

Counterpart of lilac_tpu/kernels/pallas_gemm.py. `matmul_nt(a, bt)` takes
A [M, K] and Bᵀ [N, K] (Parboil's "NT" layout) and launches the
hand-written CUDA kernel of csrc/gemm.cu for tensors on the card: a
register-tiled FFMA product, f32 products with f32 accumulation. It uses
no tensor cores and no TF32: TF32 would round every input to 11 bits
(about 2^-11 relative per product), which at K = 4096 comes near
Parboil's 1e-4·max|C| tolerance. A tensor-core design (3xTF32 through
wgmma with TMA loads) is a later redesign and must pass the same check.
Any shape runs: the kernel reads zeros past the ragged edges, so there is
no padded copy like the Pallas wrapper's `jnp.pad`.

`matmul_nt_plain` is the f64 oracle, (A·Bᵀ in float64) rounded to f32;
it is what a CPU tensor gets. `matmul_nt_torch` is the counterpart of the
reference's `matmul_nt_xla`: one `torch.matmul` with TF32 off, an option
of the sgemm workload, never its default.
"""

from __future__ import annotations

import ctypes

import torch

from lilac_tpu_torch.kernels import _cuda

_MAX_M = 65535 * 128  # grid.y of the kernel, one block row of 128


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


def _lib():
    fn = _cuda.load("gemm").lilac_matmul_nt
    if not getattr(fn, "_typed", False):
        vp = ctypes.c_void_p
        fn.argtypes = [vp, vp, vp, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, vp]
        fn.restype = ctypes.c_int
        fn._typed = True
    return fn


def matmul_nt(a: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """C = a @ bt.T with a [M, K], bt [N, K], float32 (kernel K12).

    CUDA tensors go through the kernel on the current stream (operands
    that are not contiguous are copied first) and a launch error raises;
    only CPU tensors take the plain version."""
    if not a.is_cuda:
        return matmul_nt_plain(a, bt)
    M, N, K = _check(a, bt)
    if M > _MAX_M or max(N, K) >= 2 ** 31:
        raise ValueError(f"matmul_nt: shape {(M, N, K)} exceeds the kernel's grid")
    a = a.contiguous()
    bt = bt.contiguous()
    c = torch.empty((M, N), dtype=torch.float32, device=a.device)
    if M == 0 or N == 0:
        return c
    vec = int(K % 4 == 0 and a.data_ptr() % 16 == 0 and bt.data_ptr() % 16 == 0)
    fn = _lib()
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), bt.data_ptr(), c.data_ptr(), M, N, K, vec,
                 torch.cuda.current_stream().cuda_stream)
    _cuda.check(err, "matmul_nt")
    matmul_nt.launches += 1
    return c


matmul_nt.launches = 0  # kernel launches made by the wrapper
