"""Device applier for plan-time gather routing networks.

Counterpart of lilac_tpu/kernels/routed.py for the single-table network
(`routed_apply`, kernel K1, and `masks_device`). The hierarchical appliers
and the adjoint of that module are not ported yet.

Stage primitive (same semantics as routenet.GatherPlanHost.apply_host):
    xor    d: y[i] <- mask[i] ? y[i ^ d] : y[i]
    shift  d: y[i] <- mask[i] ? y[i - d] : y[i]   (cyclic over the flat m)
    shiftl d: y[i] <- mask[i] ? y[i + d] : y[i]   (cyclic over the flat m)

`routed_apply` launches the CUDA kernel of csrc/routed.cu for tensors on
the card and takes `routed_apply_plain` only for tensors that lie on the
CPU. Both only move values, so they agree bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch

from lilac_tpu_torch.kernels import _cuda

_KIND_CODE = {"xor": 0, "shift": 1, "shiftl": 2}
_WORD_DTYPES = (torch.float32, torch.float64)
_MAX_NETS = 65535  # grid.y of the stage kernel


def check_table_feasible(m: int, nets: int = 1, *, what: str = "") -> None:
    """Raise at plan-build time when the single-table kernel cannot take a
    network of m slots.

    The kernel keeps the table in device memory and ping-pongs between two
    buffers, one launch per stage, so no on-chip memory budget bounds m:
    the limits are the slot layout (a power of two, a multiple of 1024,
    which the [R, 128] mask planes need), the grid's second dimension
    (nets <= 65535) and device memory itself. Indices are 64-bit."""
    if m < 1024 or m & (m - 1) or m % 1024:
        raise ValueError(
            f"routed plan {what or 'config'}: table size m={m} must be a "
            "power of two and a multiple of 1024"
        )
    if not 1 <= nets <= _MAX_NETS:
        raise ValueError(
            f"routed plan {what or 'config'}: {nets} nets in one call "
            f"(limit {_MAX_NETS})"
        )


def masks_device(net, device="cuda") -> torch.Tensor:
    """Host masks [S, B, m] bool -> device bit-packed [B, P, R, 128] int8
    (bit s%8 of plane s//8 = stage s; see routed_apply)."""
    return torch.as_tensor(masks_packed(net.masks), device=device)


def masks_packed(masks: np.ndarray) -> np.ndarray:
    """Bit-pack host masks [S, B, m] bool into [B, P, R, 128] int8."""
    S, B, m = masks.shape
    R = m // 128
    if m % 1024:
        raise ValueError(f"network size m={m} must be a multiple of 1024")
    P = (S + 7) // 8
    packed = np.zeros((B, P, R, 128), dtype=np.uint8)
    mk = masks.transpose(1, 0, 2).reshape(B, S, R, 128)
    for s in range(S):
        packed[:, s // 8] |= mk[:, s].astype(np.uint8) << (s % 8)
    return packed.view(np.int8)


def _check_args(x_planes, masks, kinds, dists):
    if masks.dim() != 4 or masks.shape[3] != 128 or masks.dtype != torch.int8:
        raise ValueError(
            f"masks must be int8 [B, P, R, 128], got {masks.dtype} "
            f"{tuple(masks.shape)}"
        )
    B, P, R, _ = masks.shape
    S = len(kinds)
    if S != len(dists) or P != (S + 7) // 8:
        raise ValueError(f"{S} kinds, {len(dists)} dists, {P} mask planes")
    m = R * 128
    if not 1 <= len(x_planes) <= 2:
        raise ValueError("routed_apply takes one or two value planes")
    dtype = x_planes[0].dtype
    if dtype not in _WORD_DTYPES:
        raise ValueError(f"value planes must be float32 or float64, got {dtype}")
    for x in x_planes:
        if x.dtype != dtype or x.numel() != m or x.device != masks.device:
            raise ValueError(
                f"value plane {x.dtype} {tuple(x.shape)} on {x.device} does "
                f"not match {dtype} [{R}, 128] on {masks.device}"
            )
    for k, d in zip(kinds, dists):
        if k not in _KIND_CODE or not 1 <= d < m or d & (d - 1):
            raise ValueError(f"bad stage ({k!r}, {d}) for m={m}")
    return B, P, R, m, S, dtype


def routed_apply_plain(
    x_planes: Sequence[torch.Tensor],
    masks: torch.Tensor,
    kinds: Tuple[str, ...],
    dists: Tuple[int, ...],
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of routed_apply: the stage loop of
    GatherPlanHost.apply_host on the bit-packed masks, with torch.where and
    index arithmetic. Same arguments, same result, any device."""
    B, P, R, m, S, _ = _check_args(x_planes, masks, kinds, dists)
    idx = torch.arange(m, device=masks.device)
    planes = masks.reshape(B, P, m)
    ys = [x.reshape(1, m).expand(B, m) for x in x_planes]
    bits = None
    for s, (kind, d) in enumerate(zip(kinds, dists)):
        p, bit = divmod(s, 8)
        if bit == 0:
            bits = planes[:, p].to(torch.int32)
        mask = ((bits >> bit) & 1) != 0
        if kind == "xor":
            src = idx ^ d
        elif kind == "shiftl":
            src = (idx + d) % m
        else:
            src = (idx - d) % m
        ys = [torch.where(mask, y[:, src], y) for y in ys]
    return tuple(y.reshape(B, R, 128).contiguous() for y in ys)


def _stage_args(kinds, dists):
    """kinds / dists as the C arrays the launcher reads on the host."""
    S = len(kinds)
    return (
        (ctypes.c_int * max(S, 1))(*[_KIND_CODE[k] for k in kinds]),
        (ctypes.c_longlong * max(S, 1))(*[int(d) for d in dists]),
    )


def _lib():
    lib = _cuda.load("routed")
    fn = lib.lilac_routed_apply
    if not getattr(fn, "_typed", False):
        vp = ctypes.c_void_p
        fn.argtypes = [
            vp, vp, ctypes.c_int, ctypes.c_int, vp, vp, vp, vp, vp,
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_longlong),
            vp,
        ]
        fn.restype = ctypes.c_int
        fn._typed = True
    return fn


def routed_apply(
    x_planes: Sequence[torch.Tensor],
    masks: torch.Tensor,
    kinds: Tuple[str, ...],
    dists: Tuple[int, ...],
) -> Tuple[torch.Tensor, ...]:
    """Run B gather networks over shared input planes (kernel K1).

    x_planes: one or two [R, 128] value planes (e.g. (hi, lo) for df64),
              float32 or float64, all routed through identical switches.
    masks:    [B, ceil(S/8), R, 128] int8 bit-packed switch masks: bit
              (s % 8) of plane s // 8 is stage s's mask.
    returns:  tuple of [B, R, 128] routed planes.

    CUDA tensors go through the kernel of csrc/routed.cu (one launch per
    stage on the current stream, ping-pong buffers from torch.empty); the
    launch error code is checked and raised. Only CPU tensors take the
    plain version."""
    if not masks.is_cuda:
        return routed_apply_plain(x_planes, masks, kinds, dists)
    B, P, R, m, S, dtype = _check_args(x_planes, masks, kinds, dists)
    check_table_feasible(m, B, what="routed_apply")
    if not masks.is_contiguous():
        raise ValueError("masks must be contiguous")
    xs = []
    for x in x_planes:
        if not x.is_contiguous() or x.data_ptr() % 32:
            raise ValueError("value planes must be contiguous and 32-byte aligned")
        xs.append(x)
    n = len(xs)
    outs = [torch.empty((B, R, 128), dtype=dtype, device=masks.device) for _ in xs]
    tmps = [torch.empty_like(o) for o in outs] if S > 1 else outs
    kinds_c, dists_c = _stage_args(kinds, dists)
    fn = _lib()
    with torch.cuda.device(masks.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            xs[0].data_ptr(), xs[1].data_ptr() if n == 2 else None, n,
            xs[0].element_size(),
            outs[0].data_ptr(), outs[1].data_ptr() if n == 2 else None,
            tmps[0].data_ptr(), tmps[1].data_ptr() if n == 2 else None,
            masks.data_ptr(), B, P, m, S, kinds_c, dists_c, stream,
        )
    _cuda.check(err, "routed_apply")
    routed_apply.launches += 1
    routed_apply.stage_launches += max(S, 1)
    return tuple(outs)


# wrapper calls that launched the kernel / CUDA grids those calls launched
routed_apply.launches = 0
routed_apply.stage_launches = 0
