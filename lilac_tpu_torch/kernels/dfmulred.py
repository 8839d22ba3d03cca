"""Fused df64 multiply + K-way row-sum reduction (kernel K2).

Counterpart of lilac_tpu/kernels/dfmulred.py. Computes

    y[r] = sum_k df(vals)[k, r] * df(x)[k, r]

over column-major [K, R] chunks in one pass: one read of the four input
planes and one write of the two output planes, where the eager op chain
(df.mul + pairwise df-sum tree) writes every EFT intermediate to device
memory. The accumulation is Ogita-Rump-Oishi dot2: TwoProd per term,
TwoSum into the high accumulator, first-order terms compensated in a
running low part. Error is O(K^2 eps^2 cond), f64-grade at ELL widths.

`dfmulred` (one [K, R] chunk) and `dfmulred_chunks` (every chunk of a
product, listed in a ChunkTable, in one launch) run the CUDA kernel of
csrc/dfmulred.cu for tensors on the card; `dfmulred_plain` and
`dfmulred_chunks_plain` are the same loop in eager f32 ops and are what a
CPU tensor gets. They agree bit for bit (every step rounds on its own).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import numpy as np
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


K2_ROWS = 256  # rows of one thread block of the kernel, one a thread (kRows)
GAP_SLOTS = 2048  # slots of one gap piece (ChunkTable.gap_pieces)


class ChunkTable:
    """The chunks of one product, as the kernel's grid reads them.

    spec: ((slot0, rows, K, row0), ...): chunk j's [K, rows] column-major
    slots start at slot0 of the value and x planes (term k of row r at
    slot0 + k * rows + r) and its row sums go to rows row0 .. row0 + rows
    of the output planes. `blocks` lists the kernel's thread blocks, K2_ROWS
    consecutive rows of one chunk each, as int64 rows (v0, y0, R, K << 32 |
    n): n rows from slot v0 (term stride R) to output row y0. The table is
    built once per container (see the caches in kernels/routed_spmv.py) and
    put on a device once (`blocks_on`): a product uploads nothing."""

    def __init__(self, spec):
        self.spec = tuple((int(a), int(r), int(k), int(y)) for a, r, k, y in spec)
        for slot0, rows, K, row0 in self.spec:
            if min(slot0, rows, K, row0) < 0 or K >= 1 << 31:
                raise ValueError(f"bad chunk (slot0, rows, K, row0) = "
                                 f"{(slot0, rows, K, row0)}")
        self.rows = max((y + r for _, r, _, y in self.spec), default=0)
        self.slots = max((a + k * r for a, r, k, _ in self.spec), default=0)
        parts = []
        for slot0, rows, K, row0 in self.spec:
            r0 = np.arange(0, rows, K2_ROWS, dtype=np.int64)
            n = np.minimum(K2_ROWS, rows - r0)
            parts.append(np.stack([slot0 + r0, row0 + r0, np.full_like(r0, rows),
                                   (np.int64(K) << 32) | n], axis=1))
        self.blocks = (np.concatenate(parts) if parts
                       else np.zeros((0, 4), dtype=np.int64))
        self._on: Dict[Tuple[str, int], torch.Tensor] = {}

    def gap_pieces(self, slots: int) -> np.ndarray:
        """The slots of [0, slots) no chunk covers, as pieces of at most
        GAP_SLOTS: int64 rows (s0, -1, 0, n)."""
        runs, pos = [], 0
        for a, b in sorted((s0, s0 + K * rows) for s0, rows, K, _ in self.spec):
            if a > pos:
                runs.append((pos, a))
            pos = max(pos, b)
        if pos < slots:
            runs.append((pos, slots))
        parts = [np.zeros((0, 4), dtype=np.int64)]
        for a, b in runs:
            s0 = np.arange(a, b, GAP_SLOTS, dtype=np.int64)
            n = np.minimum(GAP_SLOTS, b - s0)
            parts.append(np.stack([s0, np.full_like(s0, -1), np.zeros_like(s0), n], axis=1))
        return np.concatenate(parts)

    def blocks_on(self, device, slots: int = 0) -> torch.Tensor:
        """`blocks` on `device`; with `slots`, followed by gap_pieces(slots),
        the block list of kernels/dfadj.py's slots_mul, which writes every
        slot of its [slots] planes. Each is built and put there once."""
        key = (str(device), int(slots))
        if key not in self._on:
            rows = (self.blocks if not slots
                    else np.concatenate([self.blocks, self.gap_pieces(slots)]))
            self._on[key] = torch.as_tensor(rows, device=device)
        return self._on[key]


@functools.lru_cache(maxsize=256)
def chunk_list_table(chlist: Tuple[Tuple[int, int, int], ...]) -> ChunkTable:
    """ChunkTable of one net's (s0, rows_c, K) chunk list, its row sums
    concatenated in order."""
    spec, row0 = [], 0
    for s0, rows_c, K in chlist:
        spec.append((s0, rows_c, K, row0))
        row0 += rows_c
    return ChunkTable(spec)


def _check_chunk_planes(vh, vl, xh, xl, table: ChunkTable):
    for t in (vh, vl, xh, xl):
        if t.dtype != torch.float32 or t.dim() != 1 or t.device != vh.device:
            raise ValueError(
                "dfmulred_chunks takes four float32 1-D planes on one device, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if min(t.shape[0] for t in (vh, vl, xh, xl)) < table.slots:
        raise ValueError(f"planes of {[t.shape[0] for t in (vh, vl, xh, xl)]} "
                         f"slots, the table reads {table.slots}")


def _outputs(out, table: ChunkTable, like: torch.Tensor):
    if out is None:
        yh = torch.empty(table.rows, dtype=torch.float32, device=like.device)
        return yh, torch.empty_like(yh)
    for y in out:
        if (y.dtype != torch.float32 or y.dim() != 1 or not y.is_contiguous()
                or y.shape[0] < table.rows or y.device != like.device):
            raise ValueError(f"output planes must be contiguous float32 [>= "
                             f"{table.rows}] on {like.device}")
    return out


def dfmulred_chunks_plain(vh, vl, xh, xl, table: ChunkTable, out=None):
    """Plain PyTorch version of dfmulred_chunks: dfmulred_plain on each
    chunk of the table, the row sums concatenated (or written into `out`)."""
    _check_chunk_planes(vh, vl, xh, xl, table)
    yh, yl = _outputs(out, table, vh)
    for slot0, rows, K, row0 in table.spec:
        sl = slice(slot0, slot0 + K * rows)
        h, l_ = dfmulred_plain(*(t[sl].view(K, rows) for t in (vh, vl, xh, xl)))
        yh[row0:row0 + rows] = h
        yl[row0:row0 + rows] = l_
    return yh, yl


def _lib():
    lib = _cuda.load("dfmulred")
    if not getattr(lib, "_typed", False):
        vp, ll = ctypes.c_void_p, ctypes.c_longlong
        lib.lilac_dfmulred.argtypes = [vp, vp, ll, vp, vp, vp, vp, ctypes.c_int, ll, vp]
        lib.lilac_dfmulred_chunks.argtypes = [vp, vp, ll, vp, vp, vp, vp, vp, ll, vp]
        lib.lilac_eft_probe.argtypes = [vp, vp, vp, ll, vp]
        for fn in (lib.lilac_dfmulred, lib.lilac_dfmulred_chunks, lib.lilac_eft_probe):
            fn.restype = ctypes.c_int
        lib._typed = True
    return lib


def _vstride(vh, vl) -> int:
    vstride = vh.stride(-1) if vh.shape[-1] > 1 else 1
    if vstride not in (1, 2) or vl.stride() != vh.stride():
        raise ValueError(
            f"v planes must be contiguous or interleaved pairs, got strides "
            f"{vh.stride()} / {vl.stride()}")
    return vstride


def dfmulred(vh, vl, xh, xl):
    """Fused df64 dot of [K, R] value/x planes -> ([R], [R]) (kernel K2 on
    one chunk).

    The v planes may be contiguous or the two halves of an interleaved
    [K, R, 2] array (element stride 2); the x planes are contiguous. CUDA
    tensors go through the kernel on the current stream and the launch
    error is raised; only CPU tensors take the plain version."""
    if not vh.is_cuda:
        return dfmulred_plain(vh, vl, xh, xl)
    K, R = _check_planes(vh, vl, xh, xl)
    if not (xh.is_contiguous() and xl.is_contiguous()):
        raise ValueError("x planes must be contiguous")
    vstride = _vstride(vh, vl)
    if K > 1 and vh.stride(0) != R * vstride:
        raise ValueError(f"v planes of strides {vh.stride()} are not [K, R]")
    yh = torch.empty(R, dtype=torch.float32, device=vh.device)
    yl = torch.empty_like(yh)
    with torch.cuda.device(vh.device):
        err = _lib().lilac_dfmulred(
            vh.data_ptr(), vl.data_ptr(), vstride, xh.data_ptr(),
            xl.data_ptr(), yh.data_ptr(), yl.data_ptr(), K, R,
            torch.cuda.current_stream().cuda_stream,
        )
    _cuda.check(err, "dfmulred")
    dfmulred.launches += 1
    return yh, yl


dfmulred.launches = 0  # K2 kernel launches, by dfmulred and dfmulred_chunks


def dfmulred_chunks(vh, vl, xh, xl, table: ChunkTable, out=None):
    """Every chunk of a product in one launch of K2 -> (hi, lo) planes of
    table.rows row sums (or `out`, written in place, for a product served
    in several launches). vh, vl: 1-D value planes, contiguous or the two
    halves of an interleaved [.., 2] array; xh, xl: contiguous 1-D x
    planes; slots as the table lists them. CUDA tensors take the kernel,
    CPU tensors dfmulred_chunks_plain."""
    if not vh.is_cuda:
        return dfmulred_chunks_plain(vh, vl, xh, xl, table, out)
    _check_chunk_planes(vh, vl, xh, xl, table)
    if not (xh.is_contiguous() and xl.is_contiguous()):
        raise ValueError("x planes must be contiguous")
    vstride = _vstride(vh, vl)
    yh, yl = _outputs(out, table, vh)
    blocks = table.blocks_on(vh.device)
    with torch.cuda.device(vh.device):
        err = _lib().lilac_dfmulred_chunks(
            vh.data_ptr(), vl.data_ptr(), vstride, xh.data_ptr(), xl.data_ptr(),
            yh.data_ptr(), yl.data_ptr(), blocks.data_ptr(), blocks.shape[0],
            torch.cuda.current_stream().cuda_stream,
        )
    _cuda.check(err, "dfmulred_chunks")
    dfmulred.launches += 1
    return yh, yl


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
    out = torch.empty((4, a.numel()), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = _lib().lilac_eft_probe(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                     a.numel(), torch.cuda.current_stream().cuda_stream)
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


def chunk_mulreduce_df(vals, o_hi, o_lo, chlist, colmajor):
    """df64 per-net ELL mul+row-sum: vals [m, 2] (or a (hi, lo) tuple of
    [m] planes), o planes [m] -> (hi, lo) concatenated row sums over the
    (s0, rows_c, K) chunks.

    Column-major chunks take dfmulred_chunks (one launch for all of them);
    row-major chunks, whose terms K2 cannot read, take the op chain (df.mul
    + pairwise df-sum tree)."""
    if isinstance(vals, tuple):
        vh_m, vl_m = vals
    else:
        vh_m, vl_m = vals[..., 0], vals[..., 1]
    if not colmajor:
        prod = df.mul(df.DF(vh_m, vl_m), df.DF(o_hi, o_lo))
        return chunk_reduce_net_df(prod, chlist, colmajor)
    return dfmulred_chunks(vh_m, vl_m, o_hi, o_lo, chunk_list_table(tuple(chlist)))
