"""Fused df64 multiply + K-way row-sum reduction (kernel K2).

Counterpart of lilac_tpu/kernels/dfmulred.py. Computes

    y[r] = sum_k df(vals)[k, r] * df(x)[k, r]

over column-major [K, R] chunks in one pass: one read of the four input
planes and one write of the two output planes, where the eager op chain
(df.mul + pairwise df-sum tree) writes every EFT intermediate to device
memory. The accumulation is Ogita-Rump-Oishi dot2: TwoProd per term,
TwoSum into the high accumulator, first-order terms compensated in a
running low part. Error is O(K^2 eps^2 cond), f64-grade at ELL widths.

`dfmulred` launches the CUDA kernel of csrc/dfmulred.cu for tensors on
the card; `dfmulred_plain` is the same loop in eager f32 ops and is what a
CPU tensor gets. The two agree bit for bit (both round every step on its
own).
"""

from __future__ import annotations

import ctypes

import torch

from lilac_tpu_torch.kernels import _cuda
from lilac_tpu_torch.ops import dfloat as df


def _check_planes(vh, vl, xh, xl):
    if vh.dim() != 2:
        raise ValueError(f"planes must be [K, R], got {tuple(vh.shape)}")
    for t in (vh, vl, xh, xl):
        if t.dtype != torch.float32 or t.shape != vh.shape or t.device != vh.device:
            raise ValueError(
                "dfmulred takes four float32 [K, R] planes on one device, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
    return vh.shape


def dfmulred_plain(vh, vl, xh, xl):
    """Plain PyTorch version of dfmulred: the kernel's loop over K in
    eager f32 ops. Four [K, R] planes -> ([R], [R])."""
    K, R = _check_planes(vh, vl, xh, xl)
    s = torch.zeros(R, dtype=torch.float32, device=vh.device)
    c = torch.zeros_like(s)
    for k in range(K):
        p, ep = df._two_prod(vh[k], xh[k])
        # first-order cross terms of the df x df product
        ep = ep + (vh[k] * xl[k] + vl[k] * xh[k])
        s, es = df._two_sum(s, p)
        c = c + (es + ep)
    return df._two_sum(s, c)


def _lib():
    lib = _cuda.load("dfmulred")
    fn = lib.lilac_dfmulred
    if not getattr(fn, "_typed", False):
        vp = ctypes.c_void_p
        fn.argtypes = [vp, vp, ctypes.c_longlong, vp, vp, vp, vp,
                       ctypes.c_int, ctypes.c_longlong, vp]
        fn.restype = ctypes.c_int
        fn._typed = True
    return fn


def dfmulred(vh, vl, xh, xl):
    """Fused df64 dot of [K, R] value/x planes -> ([R], [R]) (kernel K2).

    The v planes may be contiguous or the two halves of an interleaved
    [K, R, 2] array (element stride 2); the x planes are contiguous. CUDA
    tensors go through the kernel on the current stream and the launch
    error is raised; only CPU tensors take the plain version."""
    if not vh.is_cuda:
        return dfmulred_plain(vh, vl, xh, xl)
    K, R = _check_planes(vh, vl, xh, xl)
    if not (xh.is_contiguous() and xl.is_contiguous()):
        raise ValueError("x planes must be contiguous")
    vstride = vh.stride(1) if R > 1 else 1
    if vstride not in (1, 2) or vl.stride() != vh.stride() or (
        K > 1 and vh.stride(0) != R * vstride
    ):
        raise ValueError(
            f"v planes must be contiguous or interleaved pairs, got strides "
            f"{vh.stride()} / {vl.stride()}"
        )
    yh = torch.empty(R, dtype=torch.float32, device=vh.device)
    yl = torch.empty_like(yh)
    fn = _lib()
    with torch.cuda.device(vh.device):
        err = fn(
            vh.data_ptr(), vl.data_ptr(), vstride, xh.data_ptr(),
            xl.data_ptr(), yh.data_ptr(), yl.data_ptr(), K, R,
            torch.cuda.current_stream().cuda_stream,
        )
    _cuda.check(err, "dfmulred")
    dfmulred.launches += 1
    return yh, yl


dfmulred.launches = 0  # kernel launches made by the wrapper


def eft_probe(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """TwoSum and TwoProd as compiled into the K2 translation unit, on CUDA
    f32 vectors a, b: returns [4, n] rows (s, e_sum, p, e_prod). A run on
    the card holds these against f64 to prove that no step was contracted
    or folded."""
    if not (a.is_cuda and a.dtype == torch.float32 and a.dim() == 1
            and a.is_contiguous() and b.is_contiguous()
            and b.dtype == a.dtype and b.shape == a.shape
            and b.device == a.device):
        raise ValueError("eft_probe takes two contiguous CUDA float32 vectors")
    lib = _cuda.load("dfmulred")
    fn = lib.lilac_eft_probe
    vp = ctypes.c_void_p
    fn.argtypes = [vp, vp, vp, ctypes.c_longlong, vp]
    fn.restype = ctypes.c_int
    out = torch.empty((4, a.numel()), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(),
                 torch.cuda.current_stream().cuda_stream)
    _cuda.check(err, "eft_probe")
    return out


def chunk_reduce_net_df(prod: df.DF, chlist, colmajor=False):
    """df64 per-net ELL row sums by the op chain -> (hi, lo) 1D
    concatenated tensors over the (s0, rows_c, K) chunks."""
    his, los = [], []
    for (s0, rows_c, K) in chlist:
        ph = prod.hi[s0 : s0 + rows_c * K]
        pl_ = prod.lo[s0 : s0 + rows_c * K]
        if colmajor:
            t = df.sum_df0(df.DF(ph.reshape(K, rows_c), pl_.reshape(K, rows_c)))
        else:
            t = df.sum_df(df.DF(ph.reshape(rows_c, K), pl_.reshape(rows_c, K)),
                          axis=1)
        his.append(t.hi)
        los.append(t.lo)
    hi = his[0] if len(his) == 1 else torch.cat(his)
    lo = los[0] if len(los) == 1 else torch.cat(los)
    return hi, lo


def chunk_mulreduce_df(vals, o_hi, o_lo, chlist, colmajor, *, fused=None):
    """df64 per-net ELL mul+row-sum: vals [m, 2] (or a (hi, lo) tuple of
    [m] planes), o planes [m] -> (hi, lo) concatenated row sums over the
    (s0, rows_c, K) chunks.

    Column-major chunks take dfmulred (one launch per chunk) when the
    df_fused knob is on; with df_fused=0, or a row-major plan, they take
    the op chain (df.mul + pairwise df-sum tree). `fused` overrides the
    knob."""
    if isinstance(vals, tuple):
        vh_m, vl_m = vals
    else:
        vh_m, vl_m = vals[..., 0], vals[..., 1]
    if fused is None:
        from lilac_tpu_torch.config import cfg

        fused = cfg().df_fused
    if not (colmajor and fused):
        prod = df.mul(df.DF(vh_m, vl_m), df.DF(o_hi, o_lo))
        return chunk_reduce_net_df(prod, chlist, colmajor)
    his, los = [], []
    for (s0, rows_c, K) in chlist:
        sl = slice(s0, s0 + rows_c * K)
        h, l_ = dfmulred(
            vh_m[sl].view(K, rows_c),
            vl_m[sl].view(K, rows_c),
            o_hi[sl].view(K, rows_c),
            o_lo[sl].view(K, rows_c),
        )
        his.append(h)
        los.append(l_)
    hi = his[0] if len(his) == 1 else torch.cat(his)
    lo = los[0] if len(los) == 1 else torch.cat(los)
    return hi, lo
