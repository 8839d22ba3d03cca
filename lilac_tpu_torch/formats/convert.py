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

from lilac_tpu_torch.formats.sparse import (
    BSR,
    COO,
    CSR,
    ELL,
    BucketELL,
    JagELLT,
    SegBucketELL,
    SegELLScan,
    SlicedELL,
)


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



def length_relabel_csr(
    indptr: np.ndarray,
    indices: np.ndarray,
    data: np.ndarray,
    shape: Tuple[int, int],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Similarity relabel A' = P A Pᵀ with P ordering rows by descending
    row length (square matrices).

    A routed plan built from A' has its rows already length-sorted, so the
    per-matvec un-permute network vanishes (kernels/routed_spmv.py builds
    it only when rows are out of sorted order). Iterations of the form
    x' ← f(A'x') are the exact relabeling of x ← f(Ax) for any elementwise
    f plus permutation-invariant scalars (dots, norms, means), so solver
    histories are unchanged; callers map vectors in with `v[order]` and
    back out with `out[order] = v'`.

    Returns (indptr', indices', data', order, rank) with
    order[i'] = original row at new position i', rank = inverse.
    """
    n, ncols = shape
    assert n == ncols, "length_relabel_csr is a similarity: square only"
    counts = np.diff(indptr)
    order = np.argsort(-counts, kind="stable")
    rank = np.empty(n, dtype=np.int64)
    rank[order] = np.arange(n)
    rows_old = np.repeat(np.arange(n, dtype=np.int64), counts)
    ip, ix, dv = coo_to_csr_arrays(
        rank[rows_old], rank[indices], data, shape, sum_duplicates=False
    )
    return ip, ix, dv, order, rank

def _segment_runs(indptr, indices, n: int, seg_size: int, nseg: int):
    """Per entry of a (row, column)-sorted CSR: its row, its segment and its
    slot within its (row, segment) run; and the [n, nseg] run lengths."""
    counts = np.diff(indptr).astype(np.int64)
    rows_rep = np.repeat(np.arange(n), counts)
    seg_of = indices // seg_size
    run_key = rows_rep * nseg + seg_of
    run_start = np.zeros(len(indices), dtype=bool)
    if len(indices):
        run_start[0] = True
        run_start[1:] = run_key[1:] != run_key[:-1]
    run_id = np.cumsum(run_start) - 1
    first_of_run = np.zeros(run_id[-1] + 1 if len(indices) else 0, dtype=np.int64)
    first_of_run[run_id[run_start]] = np.nonzero(run_start)[0]
    slot_in_run = np.arange(len(indices)) - first_of_run[run_id]
    rs_counts = np.zeros((n, nseg), dtype=np.int64)
    np.add.at(rs_counts, (rows_rep, seg_of), 1)
    return rows_rep, seg_of, slot_in_run, rs_counts


def _tail_slots(rows_rep, ov, n: int):
    """Rows of the overflow entries `ov` ((row, column)-sorted) and each
    one's slot within its row's overflow."""
    trows = rows_rep[ov]
    tstart = np.zeros(n + 1, dtype=np.int64)
    np.add.at(tstart, trows + 1, 1)
    np.cumsum(tstart, out=tstart)
    return trows, np.arange(len(ov)) - tstart[trows], tstart


def _seg_bucket_multiseg_arrays(indptr, indices, data, shape, seg_size, nseg,
                                seg_quantile):
    """Several column segments: a main part a segment at the seg_quantile
    width of that segment's run lengths (local indices, identity rows),
    then the entries beyond into one full-height tail part (segment -1,
    global indices)."""
    n, _ = shape
    rows_rep, seg_of, slot_in_run, rs_counts = _segment_runs(
        indptr, indices, n, seg_size, nseg)
    datas, idxs, parts = [], [], []
    overflow_mask = np.zeros(len(indices), dtype=bool)
    for s in range(nseg):
        w = max(int(np.percentile(rs_counts[:, s], seg_quantile)), 1)
        sel = (seg_of == s) & (slot_in_run < w)
        overflow_mask |= (seg_of == s) & (slot_in_run >= w)
        bi = np.zeros((n, w), dtype=np.int64)
        bv = np.zeros((n, w) + data.shape[1:], dtype=data.dtype)
        bi[rows_rep[sel], slot_in_run[sel]] = indices[sel] - s * seg_size
        bv[rows_rep[sel], slot_in_run[sel]] = data[sel]
        datas.append(bv)
        idxs.append(bi)
        parts.append((0, n, s, w))
    ov = np.nonzero(overflow_mask)[0]
    if len(ov):
        trows, tslot, tstart = _tail_slots(rows_rep, ov, n)
        wt = int(np.diff(tstart).max())
        bi = np.zeros((n, wt), dtype=np.int64)
        bv = np.zeros((n, wt) + data.shape[1:], dtype=data.dtype)
        bi[trows, tslot] = indices[ov]
        bv[trows, tslot] = data[ov]
        datas.append(bv)
        idxs.append(bi)
        parts.append((0, n, -1, wt))
    return datas, idxs, np.arange(n, dtype=np.int64), tuple(parts), True


def seg_bucket_ell_arrays(
    indptr, indices, data, shape, *, seg_size=163840, quantiles=(50, 90),
    seg_quantile=95.0,
):
    """Host arrays of a SegBucketELL: returns (datas, idxs, inv_perm, parts,
    identity), all numpy / Python, the reference's arrays bit for bit.
    seg_size >= ncols: one segment, rows bucketed at the `quantiles` of the
    row lengths. Smaller: several segments, each capped at the
    `seg_quantile` of its run lengths, and a tail (see SegBucketELL). The
    entries must be (row, column)-sorted, as coo_to_csr_arrays leaves them."""
    n, ncol = shape
    nseg = -(-ncol // seg_size)
    if nseg > 1:
        return _seg_bucket_multiseg_arrays(
            indptr, indices, data, shape, seg_size, nseg, seg_quantile)
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
    indptr, indices, data, shape, *, seg_size=163840, quantiles=(50, 90),
    seg_quantile=95.0, device="cuda",
) -> SegBucketELL:
    """Host build for SegBucketELL (see formats/sparse.py and
    seg_bucket_ell_arrays), placed on `device`."""
    datas, idxs, inv_perm, parts, identity = seg_bucket_ell_arrays(
        indptr, indices, data, shape, seg_size=seg_size, quantiles=quantiles,
        seg_quantile=seg_quantile,
    )
    return SegBucketELL(
        data=tuple(torch.as_tensor(v, device=device) for v in datas),
        indices=tuple(_index(i, device) for i in idxs),
        inv_perm=_index(inv_perm, device),
        shape=tuple(shape),
        parts=parts,
        seg_size=seg_size,
        identity_perm=identity,
    )


def csr_to_seg_ell_scan(
    indptr, indices, data, shape, *, seg_size=163840, seg_quantile=97.0,
    device="cuda",
) -> SegELLScan:
    """Host build for SegELLScan (see formats/sparse.py), the reference's
    arrays bit for bit, placed on `device`. One width for every segment:
    the largest over segments of the `seg_quantile` percentile of the
    (row, segment) run lengths; the first `width` entries of each run go
    into that segment's slab, the rest into the global-index tail. The
    entries must be (row, column)-sorted."""
    n, ncol = shape
    nseg = -(-ncol // seg_size)
    rows_rep, seg_of, slot_in_run, rs_counts = _segment_runs(
        indptr, indices, n, seg_size, nseg)
    w = max(
        1,
        int(max(np.percentile(rs_counts[:, s], seg_quantile) for s in range(nseg)))
        if n
        else 1,
    )
    main = slot_in_run < w
    # w-major slabs [nseg, w, n]: a segment's slot k of every row is contiguous
    mi = np.zeros((nseg, w, n), dtype=np.int64)
    mv = np.zeros((nseg, w, n) + data.shape[1:], dtype=data.dtype)
    mi[seg_of[main], slot_in_run[main], rows_rep[main]] = (
        indices[main] - seg_of[main] * seg_size
    )
    mv[seg_of[main], slot_in_run[main], rows_rep[main]] = data[main]

    ov = np.nonzero(~main)[0]
    tv = ti = tp = None
    if len(ov):
        trows, tslot, tstart = _tail_slots(rows_rep, ov, n)
        tail_rows = np.unique(trows)  # sorted
        m_t = len(tail_rows)
        pos_of = np.full(n, m_t, dtype=np.int64)
        pos_of[tail_rows] = np.arange(m_t)
        wt = int(np.diff(tstart).max())
        ti_np = np.zeros((wt, m_t), dtype=np.int64)
        tv_np = np.zeros((wt, m_t) + data.shape[1:], dtype=data.dtype)
        ti_np[tslot, pos_of[trows]] = indices[ov]
        tv_np[tslot, pos_of[trows]] = data[ov]
        ti = _index(ti_np, device)
        tv = torch.as_tensor(tv_np, device=device)
        tp = _index(pos_of, device)
    return SegELLScan(
        main_data=torch.as_tensor(mv, device=device),
        main_indices=_index(mi, device),
        tail_data=tv,
        tail_indices=ti,
        tail_pos=tp,
        shape=tuple(shape),
        seg_size=seg_size,
        nseg=nseg,
        width=w,
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


def csr_to_sliced_ell_arrays(indptr, indices, data, shape, slice_height=8):
    """SELL-C packing: rows sorted by descending length (stable), padded per
    slice of `slice_height` rows, column-major within a slice. Returns
    (values [total_slots], int32 column ids, int32 slot offsets of the
    slices, int32 perm), the reference's arrays bit for bit."""
    n = shape[0]
    counts = np.diff(indptr).astype(np.int64)
    npad = round_up(max(n, 1), slice_height)
    counts_pad = np.zeros(npad, dtype=np.int64)
    counts_pad[:n] = counts
    perm = np.argsort(-counts_pad, kind="stable").astype(np.int32)
    nslices = npad // slice_height
    slice_k = counts_pad[perm].reshape(nslices, slice_height).max(axis=1)
    slot_starts = np.zeros(nslices + 1, dtype=np.int64)
    np.cumsum(slice_k * slice_height, out=slot_starts[1:])
    total = int(slot_starts[-1])
    vals = np.zeros((total,) + data.shape[1:], dtype=data.dtype)
    cols = np.zeros(total, dtype=np.int32)
    # entry of row r, slot k -> slice base + position in the slice + k * height
    pos = np.empty(npad, dtype=np.int64)
    pos[perm] = np.arange(npad)
    nnz = int(indptr[-1])
    p = pos[np.repeat(np.arange(n), counts)]
    slot = np.arange(nnz) - np.repeat(indptr[:-1].astype(np.int64), counts)
    dst = slot_starts[p // slice_height] + p % slice_height + slot * slice_height
    vals[dst] = data[:nnz]
    cols[dst] = indices[:nnz]
    return vals, cols, slot_starts.astype(np.int32), perm


def sliced_ell_device(indptr, indices, data, shape, slice_height=8, dtype=None,
                      device="cuda") -> SlicedELL:
    if dtype is not None:
        data = data.astype(dtype)
    vals, cols, starts, perm = csr_to_sliced_ell_arrays(
        indptr, indices, data, shape, slice_height)
    return SlicedELL(data=_values(vals, None, device), indices=_index(cols, device),
                     row_starts=_index(starts, device), perm=_index(perm, device),
                     shape=tuple(shape), slice_height=slice_height)


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


def jag_ellt_arrays(indptr, indices, data_pair, shape, *, max_buckets: int = 6):
    """Host part of csr_sorted_to_jag_ellt: (data_hi, data_lo, indices,
    row_counts), per bucket [K_b, rows_b] float32 / float32 / int32 arrays
    and rows_b, bit-identical to the reference's.

    Buckets are contiguous row ranges chosen greedily: a bucket extends
    while counts stay >= 3/4 of its leading (max) count; the max_buckets-th
    bucket takes the whole remaining tail at its leading K. Zero-count rows
    (sorted to the tail) are dropped."""
    n = shape[0]
    counts = np.diff(indptr).astype(np.int64)
    if (np.diff(counts) > 0).any():
        raise ValueError("csr_sorted_to_jag_ellt: rows must be length-sorted "
                         "(descending counts)")
    n_nz = int(np.searchsorted(-counts, 0, side="left"))

    bounds = []
    i = 0
    while i < n_nz:
        K = int(counts[i])
        if len(bounds) + 1 == max_buckets:
            j = n_nz  # last bucket takes the tail at its leading K
        else:
            j = int(np.searchsorted(-counts, -max(1, (3 * K) // 4), side="right"))
            j = max(j, i + 1)
        bounds.append((i, j, K))
        i = j

    dh, dl, ix, rc = [], [], [], []
    for (i0, i1, K) in bounds:
        rows_b = i1 - i0
        vh = np.zeros((K, rows_b), dtype=np.float32)
        vl = np.zeros((K, rows_b), dtype=np.float32)
        ii = np.zeros((K, rows_b), dtype=np.int32)
        lo_e, hi_e = int(indptr[i0]), int(indptr[i1])
        cnt = counts[i0:i1]
        r_e = np.repeat(np.arange(rows_b), cnt)
        k_e = np.arange(hi_e - lo_e) - np.repeat(indptr[i0:i1] - lo_e, cnt)
        vh[k_e, r_e] = data_pair[lo_e:hi_e, 0]
        vl[k_e, r_e] = data_pair[lo_e:hi_e, 1]
        ii[k_e, r_e] = indices[lo_e:hi_e]
        dh.append(vh)
        dl.append(vl)
        ix.append(ii)
        rc.append(rows_b)
    return dh, dl, ix, rc


def csr_sorted_to_jag_ellt(
    indptr, indices, data_pair, shape, *, max_buckets: int = 6, device="cuda"
) -> JagELLT:
    """Stage a length-SORTED CSR (descending row counts) as JagELLT on
    `device`. data_pair: [nnz, 2] (hi, lo) f32 split values
    (df.split_f64_np). See jag_ellt_arrays for the buckets."""
    dh, dl, ix, rc = jag_ellt_arrays(indptr, indices, data_pair, shape,
                                     max_buckets=max_buckets)
    return JagELLT(
        data_hi=tuple(torch.as_tensor(a, device=device) for a in dh),
        data_lo=tuple(torch.as_tensor(a, device=device) for a in dl),
        indices=tuple(_index(a, device) for a in ix),
        shape=tuple(shape),
        row_counts=tuple(rc),
    )
