"""The df64 transpose product's glue at one launch each (csrc/dfadj.cu).

A df64 Aᵀu through a routed plan run in reverse (kernels/routed_spmv.py:
`routed_spmv_adj_t_df`, `routed_hier_spmv_adj_t_df`) expands the row
cotangents over their slots and multiplies them by the slot-ordered values
before the reverse network, then sums the network's output over the nets.
Eagerly that is a zero-fill and a copy a chunk, df.mul's 24 launches over
every slot, and df.sum_df0's 20 launches a tree level; here it is two
entries:

* `slots_mul(vh, vl, uh, ul, table)`: slot s of the [S] output planes is
  df.mul(v[s], u[row]) for the row whose term K2's chunk table puts at s,
  and df.mul(v[s], +0) where no chunk covers s. One launch.
* `netsum(oh, ol, acc=None)`: df.sum_df0 over the leading axis of [k, m]
  planes, then df.add(acc, it) where acc is given. One launch up to
  MAX_NETS rows; beyond, the tree's first levels one launch each.

Both return the chain's bits (every EFT step rounded on its own, in the
chain's order) and take float32 CUDA planes only: anything else raises.
On the CPU and for row-major plans the adjoints run the chains: the
expand (routed_spmv._adj_slots / _hier_adj_slots) and df.mul, and
`netsum_plain`. Each launch sits inside the span `lilac.kernels.adjmul`
or `lilac.kernels.netsum`.
"""

from __future__ import annotations

import ctypes

import torch

from lilac_tpu_torch.kernels import _cuda
from lilac_tpu_torch.kernels.dfdot import device_sms
from lilac_tpu_torch.kernels.dfmulred import ChunkTable
from lilac_tpu_torch.ops import dfloat as df
from lilac_tpu_torch.utils.profiling import span

_ADJMUL = span("lilac.kernels.adjmul")
_NETSUM = span("lilac.kernels.netsum")

MAX_NETS = 32  # rows netsum sums in registers in one launch (kMaxNets)

# kernel launches by entry
launches = {"slots_mul": 0, "netsum": 0}


def netsum_plain(oh, ol, acc: df.DF | None = None) -> df.DF:
    """The chain netsum replaces: df.sum_df0, then df.add(acc, it)."""
    t = df.sum_df0(df.DF(oh, ol))
    return t if acc is None else df.add(acc, t)


def _lib():
    lib = _cuda.load("dfadj")
    if not getattr(lib, "_typed", False):
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.lilac_dfadj_slots_mul.argtypes = [vp, vp, ll, vp, vp, vp, vp, vp, ll, vp]
        lib.lilac_dfadj_netsum.argtypes = [vp, vp, ll, ll, vp, vp, vp, vp, i, vp]
        lib.lilac_dfadj_netsum_level.argtypes = [vp, vp, ll, ll, vp, vp, i, vp]
        for fn in (lib.lilac_dfadj_slots_mul, lib.lilac_dfadj_netsum,
                   lib.lilac_dfadj_netsum_level):
            fn.restype = i
        lib._typed = True
    return lib


def _refuse(entry: str, what: str, planes) -> None:
    raise ValueError(
        f"dfadj.{entry} takes float32 CUDA planes on one device ({what}), got "
        f"{[(str(p.dtype), tuple(p.shape), tuple(p.stride()), str(p.device)) for p in planes]}")


def slots_mul(vh, vl, uh, ul, table: ChunkTable) -> df.DF:
    """One launch: slot s of the returned [S] planes is df.mul(v[s], u[r])
    where `table` puts a term of row r at s, df.mul(v[s], +0) where no
    chunk covers s. vh, vl: 1-D value planes of S >= table.slots,
    contiguous or the two halves of an interleaved [.., 2] array; uh, ul:
    contiguous 1-D row cotangents of at least table.rows."""
    planes = (vh, vl, uh, ul)
    dev = vh.device
    if not (dev.type == "cuda" and all(
            t.dtype == torch.float32 and t.dim() == 1 and t.device == dev for t in planes)):
        _refuse("slots_mul", "1-D", planes)
    S = vh.shape[0]
    vstride = vh.stride(0) if S > 1 else 1
    if (S < 1 or vl.shape[0] != S or S < table.slots or vstride not in (1, 2)
            or (vl.stride(0) if S > 1 else 1) != vstride
            or (vstride == 2 and vl.data_ptr() != vh.data_ptr() + 4)
            or not (uh.is_contiguous() and ul.is_contiguous())
            or min(uh.shape[0], ul.shape[0]) < table.rows):
        _refuse("slots_mul", f"values of >= {table.slots} slots, contiguous or one "
                f"interleaved pair; contiguous cotangents of >= {table.rows} rows", planes)
    blocks = table.blocks_on(dev, S)
    oh = torch.empty(S, dtype=torch.float32, device=dev)
    ol = torch.empty_like(oh)
    with _ADJMUL:
        err = _cuda.launch_on(dev.index, lambda stream: _lib().lilac_dfadj_slots_mul(
            vh.data_ptr(), vl.data_ptr(), vstride, uh.data_ptr(), ul.data_ptr(),
            oh.data_ptr(), ol.data_ptr(), blocks.data_ptr(), blocks.shape[0], stream))
        _cuda.check(err, "dfadj.slots_mul")
    launches["slots_mul"] += 1
    return df.DF(oh, ol)


def netsum(oh, ol, acc: df.DF | None = None) -> df.DF:
    """netsum_plain(oh, ol, acc): oh, ol contiguous [k, m] planes, acc
    (optional) contiguous [m] planes. Returns new [m] planes."""
    planes = (oh, ol) + (() if acc is None else tuple(acc))
    dev = oh.device
    if not (dev.type == "cuda" and all(
            t.dtype == torch.float32 and t.device == dev and t.is_contiguous()
            for t in planes)):
        _refuse("netsum", "contiguous", planes)
    if (oh.dim() != 2 or ol.shape != oh.shape or oh.numel() == 0
            or (acc is not None and any(t.shape != oh.shape[1:] for t in acc))):
        _refuse("netsum", "[k, m] and an [m] accumulator", planes)
    k, m = oh.shape
    sms = device_sms(dev.index)
    lib = _lib()
    with _NETSUM:
        xh, xl = oh, ol
        while k > MAX_NETS:  # the tree's first levels, a launch each
            half = (k + 1) // 2
            yh = torch.empty((half, m), dtype=torch.float32, device=dev)
            yl = torch.empty_like(yh)
            err = _cuda.launch_on(dev.index, lambda stream: lib.lilac_dfadj_netsum_level(
                xh.data_ptr(), xl.data_ptr(), k, m, yh.data_ptr(), yl.data_ptr(), sms,
                stream))
            _cuda.check(err, "dfadj.netsum")
            launches["netsum"] += 1
            xh, xl, k = yh, yl, half
        yh = torch.empty(m, dtype=torch.float32, device=dev)
        yl = torch.empty_like(yh)
        ah, al = (None, None) if acc is None else (acc.hi.data_ptr(), acc.lo.data_ptr())
        err = _cuda.launch_on(dev.index, lambda stream: lib.lilac_dfadj_netsum(
            xh.data_ptr(), xl.data_ptr(), k, m, ah, al, yh.data_ptr(), yl.data_ptr(),
            sms, stream))
        _cuda.check(err, "dfadj.netsum")
    launches["netsum"] += 1
    return df.DF(yh, yl)
