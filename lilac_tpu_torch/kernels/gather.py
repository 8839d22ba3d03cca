"""Gather SpMV on torch index ops: the port's plain operators.

Counterpart of lilac_tpu/kernels/xla.py. What the JAX package left to
XLA's gather, segment-sum and scatter-add is plain torch indexing,
`index_add_` and `sum` here; no hand kernel is involved, which makes these
the check on the routed operators. They are registered under the
reference's names (xla_csr, xla_coo, xla_ell, xla_ell_df, xla_bsr,
xla_sell, xla_sell_df, xla_segell, xla_segell_df), so a kernel name means
the same computation on both platforms.

Each transpose form (`*_t`) is the true Aᵀx by scatter-add.
"""

from __future__ import annotations

import torch

from lilac_tpu_torch.formats.sparse import BSR, COO, CSR, ELL, BucketELL, SegBucketELL
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


# -- SegBucketELL (single segment) ---------------------------------------------


def seg_bucket_ell_spmv(A: SegBucketELL, x: torch.Tensor) -> torch.Tensor:
    acc = {}
    for (lo, hi, _s, _w), v, i in zip(A.parts, A.data, A.indices):
        part = (v * x[i]).sum(dim=1)
        prev = acc.get((lo, hi))
        acc[(lo, hi)] = part if prev is None else prev + part
    y = torch.cat([acc[k] for k in sorted(acc)])
    if A.identity_perm:
        return y
    return pair_gather(y, A.inv_perm)


def seg_bucket_ell_spmv_df(A: SegBucketELL, x: df.DF) -> df.DF:
    acc = {}
    for (lo, hi, _s, _w), v, i in zip(A.parts, A.data, A.indices):
        a = df.DF(v[..., 0], v[..., 1])
        t = df.sum_df(df.mul(a, df.DF(x.hi[i], x.lo[i])), axis=1)
        prev = acc.get((lo, hi))
        acc[(lo, hi)] = t if prev is None else df.add(prev, t)
    his = torch.cat([acc[k].hi for k in sorted(acc)])
    los = torch.cat([acc[k].lo for k in sorted(acc)])
    if A.identity_perm:
        return df.DF(his, los)
    return df.DF(his[A.inv_perm], los[A.inv_perm])


register_kernel("xla_segell", seg_bucket_ell_spmv, SegBucketELL)
register_kernel("xla_segell_df", seg_bucket_ell_spmv_df, SegBucketELL, dfloat=True)
