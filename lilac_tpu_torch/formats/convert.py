"""Host-side (numpy) format construction and conversion.

Counterpart of lilac_tpu/formats/convert.py: the converters the factored
NPB path uses. The conversions run once at plan-build time on numpy
arrays; the last step places the result on ``device``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from lilac_tpu_torch.formats.sparse import SegBucketELL


def coo_to_csr_arrays(
    row: np.ndarray,
    col: np.ndarray,
    val: np.ndarray,
    shape: Tuple[int, int],
    sum_duplicates: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Build canonical CSR (indptr, indices, data) from COO triples.

    Duplicate (row, col) entries are summed (matching the NPB `sparse`
    assembly, cg.f:814-871, which sums duplicated outer-product
    contributions in place).
    """
    n, _ = shape
    order = np.lexsort((col, row))
    row, col, val = row[order], col[order], val[order]
    if sum_duplicates and len(row):
        keep = np.empty(len(row), dtype=bool)
        keep[0] = True
        keep[1:] = (row[1:] != row[:-1]) | (col[1:] != col[:-1])
        group = np.cumsum(keep) - 1
        uval = np.zeros(int(group[-1]) + 1, dtype=val.dtype)
        np.add.at(uval, group, val)
        row, col, val = row[keep], col[keep], uval
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, row + 1, 1)
    np.cumsum(indptr, out=indptr)
    return (
        indptr.astype(np.int32),
        col.astype(np.int32),
        val,
    )


def seg_bucket_ell_arrays(
    indptr, indices, data, shape, *, seg_size=None, quantiles=(50, 90)
):
    """Host arrays of a single-segment SegBucketELL: returns
    (datas, idxs, inv_perm, parts, identity), all numpy / Python.
    seg_size: the column-segment length (default: ncols, one segment)."""
    n, ncol = shape
    seg_size = ncol if seg_size is None else seg_size
    nseg = -(-ncol // seg_size)
    if nseg > 1:
        raise NotImplementedError(
            "multi-segment SegBucketELL is not ported: the factored NPB path "
            "always passes seg_size >= ncols"
        )
    counts = np.diff(indptr).astype(np.int64)
    kmax = int(counts.max()) if n else 0
    cand = sorted({max(int(np.percentile(counts, q)), 1) for q in quantiles} | {kmax})
    identity = bool(cand and cand[0] * 1.25 >= kmax)
    if identity:
        # near-uniform row lengths: bucketing and the output un-permute
        # buy nothing, keep original order (the kernel skips the un-permute)
        cand = [kmax]
        perm = np.arange(n, dtype=np.int64)
        inv_perm = perm
    else:
        perm = np.argsort(counts, kind="stable")
        inv_perm = np.empty(n, dtype=np.int64)
        inv_perm[perm] = np.arange(n)
    sorted_counts = counts[perm]

    rows_rep = np.repeat(np.arange(n), counts)
    # entries are sorted by (row, col): slot within the row
    slot_in_row = np.arange(len(indices)) - np.repeat(
        indptr[:-1].astype(np.int64), counts
    )

    datas, idxs, parts = [], [], []
    lo = 0
    for w in cand:
        hi = int(np.searchsorted(sorted_counts, w, side="right"))
        if hi <= lo:
            continue
        rows_b = perm[lo:hi]
        pos_of = np.full(n, -1, dtype=np.int64)
        pos_of[rows_b] = np.arange(len(rows_b))
        wk = int(counts[rows_b].max()) if len(rows_b) else 0
        if wk:
            bi = np.zeros((len(rows_b), wk), dtype=np.int64)
            bv = np.zeros((len(rows_b), wk) + data.shape[1:], dtype=data.dtype)
            sel = pos_of[rows_rep] >= 0
            r_local = pos_of[rows_rep[sel]]
            k_local = slot_in_row[sel]
            bi[r_local, k_local] = indices[sel]
            bv[r_local, k_local] = data[sel]
            datas.append(bv)
            idxs.append(bi)
            parts.append((lo, hi, 0, wk))
        lo = hi
    return datas, idxs, inv_perm, tuple(parts), identity


def csr_to_seg_bucket_ell(
    indptr, indices, data, shape, *, seg_size=None, quantiles=(50, 90),
    device="cuda",
) -> SegBucketELL:
    """Host build for SegBucketELL (see formats/sparse.py), single column
    segment: seg_size defaults to ncols and must not be smaller."""
    seg_size = shape[1] if seg_size is None else seg_size
    datas, idxs, inv_perm, parts, identity = seg_bucket_ell_arrays(
        indptr, indices, data, shape, seg_size=seg_size, quantiles=quantiles
    )
    return SegBucketELL(
        data=tuple(torch.as_tensor(v, device=device) for v in datas),
        indices=tuple(
            torch.as_tensor(i, dtype=torch.int64, device=device) for i in idxs
        ),
        inv_perm=torch.as_tensor(inv_perm, dtype=torch.int64, device=device),
        shape=tuple(shape),
        parts=parts,
        seg_size=seg_size,
        identity_perm=identity,
    )
