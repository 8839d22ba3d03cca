"""Gather SpMV on torch index ops: the port's plain operators.

Counterpart of lilac_tpu/kernels/xla.py. What the JAX package left to
XLA's gather, segment-sum and scatter-add is plain torch indexing,
`index_add_` and `sum` here; no hand kernel is involved, which makes these
the check on the routed operators. They are registered under the
reference's names (xla_csr, xla_coo, xla_ell, xla_ell_df, xla_bsr,
xla_sell, xla_sell_df, xla_segell, xla_segell_df, xla_segscan,
xla_segscan_df), so a kernel name means the same computation on both
platforms. `jag_ellt_spmv_df` (the `mixed` factored layout's V^T) is, as in
the reference, not registered.

Each transpose form (`*_t`) is the true Aᵀx by scatter-add.
"""

from __future__ import annotations

import torch

from lilac_tpu_torch.formats.sparse import (
    BSR,
    COO,
    CSR,
    ELL,
    BucketELL,
    JagELLT,
    SegBucketELL,
    SegELLScan,
)
from lilac_tpu_torch.kernels.registry import register_kernel
from lilac_tpu_torch.ops import dfloat as df


def pair_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx]. (The reference gathers [*, 2] rows to reach a faster XLA
    emitter; torch's index kernel needs no such shaping.)"""
    return x[idx]


def _scatter_add(n: int, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """zeros(n).at[idx].add(vals) as one index_add_."""
    return torch.zeros(n, dtype=vals.dtype, device=vals.device).index_add_(
        0, idx.reshape(-1), vals.reshape(-1))


# -- CSR ----------------------------------------------------------------------


def csr_spmv(A: CSR, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x: gather, multiply, segment-sum by row (needs A.row_ids)."""
    if A.row_ids is None:
        raise ValueError("csr_spmv needs A.with_row_ids()")
    return _scatter_add(A.shape[0], A.row_ids, A.data * x[A.indices])


def csr_spmv_t(A: CSR, x: torch.Tensor) -> torch.Tensor:
    """y = A.T @ x by scatter-add into the columns."""
    if A.row_ids is None:
        raise ValueError("csr_spmv_t needs A.with_row_ids()")
    return _scatter_add(A.shape[1], A.indices, A.data * x[A.row_ids])


register_kernel("xla_csr", csr_spmv, CSR, transpose=csr_spmv_t)


# -- COO ----------------------------------------------------------------------


def coo_spmv(A: COO, x: torch.Tensor) -> torch.Tensor:
    return _scatter_add(A.shape[0], A.row, A.data * x[A.col])


def coo_spmv_t(A: COO, x: torch.Tensor) -> torch.Tensor:
    return _scatter_add(A.shape[1], A.col, A.data * x[A.row])


register_kernel("xla_coo", coo_spmv, COO, transpose=coo_spmv_t)


# -- ELL ----------------------------------------------------------------------


def ell_spmv(A: ELL, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x: gather [rows, K], reduce K. Padding is (index 0, value 0)."""
    return (A.data * x[A.indices]).sum(dim=1)[: A.shape[0]]


def ell_spmv_t(A: ELL, x: torch.Tensor) -> torch.Tensor:
    xr = torch.nn.functional.pad(x, (0, A.nrows_pad - A.shape[0]))
    return _scatter_add(A.shape[1], A.indices, A.data * xr[:, None])


register_kernel("xla_ell", ell_spmv, ELL, transpose=ell_spmv_t)


def ell_spmv_df(A: ELL, x: df.DF) -> df.DF:
    """df64 SpMV on [rows, K, 2] (hi, lo) values: TwoProd per element,
    pairwise df-sum over the K axis."""
    a = df.DF(A.data[..., 0], A.data[..., 1])
    terms = df.mul(a, df.DF(x.hi[A.indices], x.lo[A.indices]))
    y = df.sum_df(terms, axis=1)
    return df.DF(y.hi[: A.shape[0]], y.lo[: A.shape[0]])


register_kernel("xla_ell_df", ell_spmv_df, ELL, dfloat=True)


# -- BSR ----------------------------------------------------------------------


def bsr_spmv(A: BSR, x: torch.Tensor) -> torch.Tensor:
    """Dense (bh, bw) block products, summed per block row. Block columns
    past the matrix's last column read zeros."""
    bh, bw = A.block_shape
    nbr = A.indptr.shape[0] - 1
    cols = A.indices[:, None] * bw + torch.arange(bw, device=x.device)[None, :]
    xseg = torch.where(cols < A.shape[1], x[cols % A.shape[1]], 0.0).to(A.data.dtype)
    prod = torch.einsum("brc,bc->br", A.data, xseg)
    rowid = torch.repeat_interleave(
        torch.arange(nbr, device=x.device), torch.diff(A.indptr))
    yblk = torch.zeros((nbr, bh), dtype=prod.dtype, device=x.device).index_add_(
        0, rowid, prod)
    return yblk.reshape(nbr * bh)[: A.shape[0]]


register_kernel("xla_bsr", bsr_spmv, BSR)


# -- BucketELL ----------------------------------------------------------------


def bucket_ell_spmv(A: BucketELL, x: torch.Tensor) -> torch.Tensor:
    parts = [(v * x[i]).sum(dim=1) for v, i in zip(A.data, A.indices)]
    return torch.cat(parts)[A.inv_perm]


def bucket_ell_spmv_df(A: BucketELL, x: df.DF) -> df.DF:
    his, los = [], []
    for v, i in zip(A.data, A.indices):
        a = df.DF(v[..., 0], v[..., 1])
        yb = df.sum_df(df.mul(a, df.DF(x.hi[i], x.lo[i])), axis=1)
        his.append(yb.hi)
        los.append(yb.lo)
    return df.DF(torch.cat(his)[A.inv_perm], torch.cat(los)[A.inv_perm])


def bucket_ell_spmv_t(A: BucketELL, x: torch.Tensor) -> torch.Tensor:
    """y = A.T @ x: x scattered back into bucket-row order (the inverse of
    the forward product's un-permute), then a scatter-add of v * x_row per
    bucket into the columns."""
    nb = sum(v.shape[0] for v in A.data)
    xb = torch.zeros(nb, dtype=x.dtype, device=x.device)
    xb[A.inv_perm] = x[: A.shape[0]]
    out = torch.zeros(A.shape[1], dtype=A.data[0].dtype, device=x.device)
    off = 0
    for v, i in zip(A.data, A.indices):
        xs = xb[off : off + v.shape[0]]
        out.index_add_(0, i.reshape(-1), (v * xs[:, None]).reshape(-1))
        off += v.shape[0]
    return out


register_kernel("xla_sell", bucket_ell_spmv, BucketELL, transpose=bucket_ell_spmv_t)
register_kernel("xla_sell_df", bucket_ell_spmv_df, BucketELL, dfloat=True)


# -- SegBucketELL ----------------------------------------------------------------


def _seg_table(x: torch.Tensor, A, s: int) -> torch.Tensor:
    """The values a part of segment s gathers from: x itself for the tail
    (s = -1, global indices) and for a single segment; segment s's slice of
    x for local indices. A padding slot's index 0 stays inside the slice,
    since a segment starts below ncols."""
    if s < 0:
        return x
    return x[s * A.seg_size:(s + 1) * A.seg_size]


def seg_bucket_ell_spmv(A: SegBucketELL, x: torch.Tensor) -> torch.Tensor:
    acc = {}
    for (lo, hi, s, _w), v, i in zip(A.parts, A.data, A.indices):
        part = (v * _seg_table(x, A, s)[i]).sum(dim=1)
        prev = acc.get((lo, hi))
        acc[(lo, hi)] = part if prev is None else prev + part
    y = torch.cat([acc[k] for k in sorted(acc)])
    if A.identity_perm:
        return y
    return pair_gather(y, A.inv_perm)


def seg_bucket_ell_spmv_df(A: SegBucketELL, x: df.DF) -> df.DF:
    acc = {}
    for (lo, hi, s, _w), v, i in zip(A.parts, A.data, A.indices):
        a = df.DF(v[..., 0], v[..., 1])
        g = df.DF(_seg_table(x.hi, A, s)[i], _seg_table(x.lo, A, s)[i])
        t = df.sum_df(df.mul(a, g), axis=1)
        prev = acc.get((lo, hi))
        acc[(lo, hi)] = t if prev is None else df.add(prev, t)
    his = torch.cat([acc[k].hi for k in sorted(acc)])
    los = torch.cat([acc[k].lo for k in sorted(acc)])
    if A.identity_perm:
        return df.DF(his, los)
    return df.DF(his[A.inv_perm], los[A.inv_perm])


register_kernel("xla_segell", seg_bucket_ell_spmv, SegBucketELL)
register_kernel("xla_segell_df", seg_bucket_ell_spmv_df, SegBucketELL, dfloat=True)


# -- SegELLScan -----------------------------------------------------------------
# The reference accumulates the segments with lax.scan; here a Python loop
# over them, in the same order: y + sum_w v * x_seg[i] a segment, then the
# tail through tail_pos. Temporaries stay one segment's [width, n] slab.


def seg_ell_scan_spmv(A: SegELLScan, x: torch.Tensor) -> torch.Tensor:
    y = torch.zeros(A.shape[0], dtype=A.main_data.dtype, device=x.device)
    for s in range(A.nseg):
        xseg = _seg_table(x, A, s)
        y = y + (A.main_data[s] * xseg[A.main_indices[s]]).sum(dim=0)
    if A.tail_data is not None:
        yt = (A.tail_data * x[A.tail_indices]).sum(dim=0)
        yt1 = torch.cat([yt, yt.new_zeros(1)])
        y = y + yt1[A.tail_pos]
    return y


def seg_ell_scan_spmv_df(A: SegELLScan, x: df.DF) -> df.DF:
    zero = torch.zeros(A.shape[0], dtype=torch.float32, device=x.hi.device)
    y = df.DF(zero, zero)
    for s in range(A.nseg):
        i = A.main_indices[s]
        v = A.main_data[s]
        g = df.DF(_seg_table(x.hi, A, s)[i], _seg_table(x.lo, A, s)[i])
        t = df.sum_df0(df.mul(df.DF(v[..., 0], v[..., 1]), g))
        y = df.add(y, t)
    if A.tail_data is not None:
        i = A.tail_indices
        a = df.DF(A.tail_data[..., 0], A.tail_data[..., 1])
        t = df.sum_df0(df.mul(a, df.DF(x.hi[i], x.lo[i])))
        pad = t.hi.new_zeros(1)
        gt = df.DF(torch.cat([t.hi, pad])[A.tail_pos], torch.cat([t.lo, pad])[A.tail_pos])
        y = df.add(y, gt)
    return y


register_kernel("xla_segscan", seg_ell_scan_spmv, SegELLScan)
register_kernel("xla_segscan_df", seg_ell_scan_spmv_df, SegELLScan, dfloat=True)


# -- JagELLT --------------------------------------------------------------------
# The reference sweeps a bucket's jagged diagonals with lax.scan; here a
# Python loop over them, in the same order: one pair-gather a diagonal,
# df.mul by its values, df.add into the bucket's accumulator.


def jag_ellt_spmv_df(A: JagELLT, x: df.DF) -> df.DF:
    """df64 y = A x as per-bucket column sweeps: every intermediate is a
    [rows_b] vector. Zero-count tail rows get zeros; a matrix of empty rows
    (zero buckets) gives a zero vector."""
    n = A.shape[0]
    dev = x.hi.device
    if len(A.row_counts) == 0:
        z = torch.zeros(n, dtype=torch.float32, device=dev)
        return df.DF(z, z.clone())
    xs = torch.stack([x.hi, x.lo], dim=-1)
    outs_h, outs_l = [], []
    for vh, vl, ix, rows_b in zip(A.data_hi, A.data_lo, A.indices, A.row_counts):
        z = torch.zeros(rows_b, dtype=torch.float32, device=dev)
        acc = df.DF(z, z.clone())
        for k in range(vh.shape[0]):
            g = pair_gather(xs, ix[k])
            acc = df.add(acc, df.mul(df.DF(vh[k], vl[k]), df.DF(g[:, 0], g[:, 1])))
        outs_h.append(acc.hi)
        outs_l.append(acc.lo)
    hi, lo = torch.cat(outs_h), torch.cat(outs_l)
    pad = n - hi.shape[0]
    if pad > 0:  # zero-count tail rows
        hi = torch.nn.functional.pad(hi, (0, pad))
        lo = torch.nn.functional.pad(lo, (0, pad))
    return df.DF(hi[:n], lo[:n])
