"""Host-side (numpy) format construction and conversion.

Counterpart of lilac_tpu/formats/convert.py. The `*_arrays` functions
return numpy arrays bit-identical to the reference's; they run once at
plan-build time. The `*_device` wrappers place the result on ``device``
as the port's containers (formats/sparse.py), index arrays as int64.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from lilac_tpu_torch.formats.sparse import BSR, COO, CSR, ELL, BucketELL, SegBucketELL


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _index(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.int64, device=device)


def _values(a, dtype, device) -> torch.Tensor:
    if dtype is not None:
        a = a.astype(dtype)
    return torch.as_tensor(np.ascontiguousarray(a), device=device)


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


def csr_device(indptr, indices, data, shape, dtype=None, with_row_ids=True,
               device="cuda") -> CSR:
    m = CSR(
        data=_values(data, dtype, device),
        indices=_index(indices, device),
        indptr=_index(indptr, device),
        shape=tuple(shape),
    )
    return m.with_row_ids() if with_row_ids else m


def coo_device(row, col, val, shape, dtype=None, device="cuda") -> COO:
    return COO(
        row=_index(row, device),
        col=_index(col, device),
        data=_values(val, dtype, device),
        shape=tuple(shape),
    )


def csr_to_ell_arrays(indptr, indices, data, shape, row_pad=8, slot_pad=1,
                      max_slots=None):
    """Pack CSR into ELL: ([nrows_pad, K] values, [nrows_pad, K] int32
    column indices). Padding slots get (index 0, value 0); `row_pad` aligns
    the row count, `slot_pad` the slot count."""
    n = shape[0]
    counts = np.diff(indptr).astype(np.int64)
    k = int(counts.max()) if len(counts) and counts.max() > 0 else 1
    k = round_up(k, slot_pad)
    if max_slots is not None and k > max_slots:
        raise ValueError(f"row length {k} exceeds max_slots {max_slots}")
    npad = round_up(max(n, 1), row_pad)
    vals = np.zeros((npad, k) + data.shape[1:], dtype=data.dtype)
    cols = np.zeros((npad, k), dtype=np.int32)
    rowid = np.repeat(np.arange(n), counts)
    slot = np.arange(len(indices), dtype=np.int64) - np.repeat(indptr[:-1], counts)
    vals[rowid, slot] = data
    cols[rowid, slot] = indices
    return vals, cols


def ell_device(indptr, indices, data, shape, dtype=None, row_pad=8, slot_pad=1,
               device="cuda") -> ELL:
    if dtype is not None:
        data = data.astype(dtype)
    vals, cols = csr_to_ell_arrays(indptr, indices, data, shape, row_pad, slot_pad)
    return ELL(data=_values(vals, None, device), indices=_index(cols, device),
               shape=tuple(shape))


def csr_to_bsr_arrays(indptr, indices, data, shape, block_shape=(8, 128)):
    """Re-block CSR into BSR with dense (bh, bw) blocks (zero-filled):
    returns (block values, block-column ids int32, block indptr int32)."""
    bh, bw = block_shape
    n, m = shape
    nbr = (n + bh - 1) // bh
    nbc = (m + bw - 1) // bw
    counts = np.diff(indptr).astype(np.int64)
    rowid = np.repeat(np.arange(n), counts)
    key = (rowid // bh).astype(np.int64) * nbc + indices // bw
    uniq = np.unique(key)
    bvals = np.zeros((len(uniq), bh, bw), dtype=data.dtype)
    block_of = np.searchsorted(uniq, key)
    np.add.at(bvals, (block_of, rowid % bh, indices % bw), data)
    ubrow = (uniq // nbc).astype(np.int64)
    ubcol = (uniq % nbc).astype(np.int32)
    bindptr = np.zeros(nbr + 1, dtype=np.int64)
    np.add.at(bindptr, ubrow + 1, 1)
    np.cumsum(bindptr, out=bindptr)
    return bvals, ubcol, bindptr.astype(np.int32)


def bsr_device(indptr, indices, data, shape, block_shape=(8, 128), dtype=None,
               device="cuda") -> BSR:
    if dtype is not None:
        data = data.astype(dtype)
    bv, bc, bp = csr_to_bsr_arrays(indptr, indices, data, shape, block_shape)
    return BSR(data=_values(bv, None, device), indices=_index(bc, device),
               indptr=_index(bp, device), shape=tuple(shape),
               block_shape=tuple(block_shape))


def dense_to_csr_arrays(dense: np.ndarray, tol: float = 0.0):
    """Dense -> CSR, keeping entries with |a_ij| > tol (exact zeros dropped)."""
    row, col = np.nonzero(np.abs(dense) > tol)
    return coo_to_csr_arrays(
        row.astype(np.int64), col.astype(np.int64), dense[row, col], dense.shape
    )


def csr_to_bucket_ell_arrays(indptr, indices, data, shape, *, quantiles=(50, 90)):
    """Split rows into width-quantile buckets (host). Returns
    (bucket_indices, bucket_values, inv_perm, widths), numpy arrays.

    Above the top quantile the widths continue as a geometric ladder (x4
    per bucket) up to the longest row, so a heavy-tailed row-length
    distribution does not pad every tail row to the global maximum."""
    n = shape[0]
    counts = np.diff(indptr).astype(np.int64)
    kmax = int(counts.max()) if n else 0
    cand_set = {max(int(np.percentile(counts, q)), 1) for q in quantiles}
    w = max(cand_set) if cand_set else 1
    while w < kmax:
        w = min(w * 4, kmax)
        cand_set.add(w)
    cand = sorted(cand_set | {kmax})
    perm = np.argsort(counts, kind="stable")
    inv_perm = np.empty(n, dtype=np.int64)
    inv_perm[perm] = np.arange(n)
    sorted_counts = counts[perm]
    # every entry's position in the sorted row order and its slot within
    # its row (entries run row by row)
    pos = inv_perm[np.repeat(np.arange(n), counts)]
    slot_in_row = np.arange(len(indices)) - np.repeat(
        indptr[:-1].astype(np.int64), counts)

    bucket_idx, bucket_val, widths = [], [], []
    lo = 0
    for w in cand:
        hi = int(np.searchsorted(sorted_counts, w, side="right"))
        if hi <= lo:
            continue
        # rows lo..hi-1 of the sorted order: entry -> (row in bucket, slot)
        sel = (pos >= lo) & (pos < hi)
        r_local = pos[sel] - lo
        bi = np.zeros((hi - lo, w), dtype=np.int64)
        bv = np.zeros((hi - lo, w) + data.shape[1:], dtype=data.dtype)
        bi[r_local, slot_in_row[sel]] = indices[sel]
        bv[r_local, slot_in_row[sel]] = data[sel]
        bucket_idx.append(bi)
        bucket_val.append(bv)
        widths.append(w)
        lo = hi
    return bucket_idx, bucket_val, inv_perm, tuple(widths)


def bucket_ell_device(indptr, indices, data, shape, dtype=None, quantiles=(50, 90),
                      device="cuda") -> BucketELL:
    if dtype is not None:
        data = data.astype(dtype)
    bi, bv, inv_perm, widths = csr_to_bucket_ell_arrays(
        indptr, indices, data, shape, quantiles=quantiles
    )
    return BucketELL(
        data=tuple(_values(v, None, device) for v in bv),
        indices=tuple(_index(i, device) for i in bi),
        inv_perm=_index(inv_perm, device),
        shape=tuple(shape),
        widths=widths,
    )
