"""SpMV through plan-time routing networks (single table, column
segments and hierarchical).

Counterpart of lilac_tpu/kernels/routed_spmv.py. Pipeline per matvec: pad x into the
network input slots ([m] = [R, 128] planes), run every row-chunk's gather
network in one routed_apply call (kernels/routed.py), then multiply by the
values, pre-arranged at PLAN time into the routed slot order, and reduce
each chunk's [rows_c, K_c] block (df64: the fused kernel of
kernels/dfmulred.py).

Rows are chunked after sorting by row length (descending), so each chunk
pads to its own max length; the row order is restored by one [n]-sized
gather at the end. Matrices with near-uniform rows skip the sort.

Single-table plans (RoutedMat) need ncols <= m with the whole table in one
kernel call. Column-segmented plans (RoutedMatSeg) cut the columns into
segments of at most 2^18 and run one single-table network group a segment
over that segment's slice of x, all segments sharing one row order. Hierarchical plans (RoutedMatHier, second half of this file)
serve larger tables: one full-size network per m-slot super-block of
terms, applied pass by pass (kernels/routed.py), rows globally sorted by
length, an un-permute network at the end where the rows were not sorted
already. On a device the nets that share a pass schedule are packed into
groups (RoutedMatHierP), one launch a pass for a whole group.

The transpose products (`routed_spmv_adj_t(_df)`, `routed_hier_spmv_adj_t
(_df)`) run the FORWARD plan backwards: Aᵀu = Gᵀ(vals ⊙ expand(u)), with
expand the adjoint of the row sums (each row's cotangent tiled over its
slots) and Gᵀ the network's adjoint (kernels K7-K11 of kernels/routed.py),
then a sum over the nets. One plan serves both directions.

Plan files (`save_routed` / `load_routed`) use the JAX package's npz
format, so a plan written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import functools
import glob
import json
import os
import time
import zipfile
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np
import torch

from lilac_tpu_torch.kernels import dfadj
from lilac_tpu_torch.kernels import dfmulred as dfk
from lilac_tpu_torch.kernels import routed as rd
from lilac_tpu_torch.kernels import routenet as rn
from lilac_tpu_torch.ops import dfloat as df
from lilac_tpu_torch.utils.profiling import BUILD, span

# the calls into the network passes (kernels/routed.py: K1, K3-K11) and
# into K2 and its chunk forms (kernels/dfmulred.py)
_ROUTE = span("lilac.kernels.route")
_MULRED = span("lilac.kernels.mulred")
_UPLOAD = span("lilac.build.plan.upload", BUILD)
_READ = span("lilac.build.plan.read", BUILD)


@dataclasses.dataclass
class RoutedMat:
    """One sparse matrix staged as routing networks + slot-ordered values.

    vals: [B, m] (or [B, m, 2] df64) values in routed slot order
    chunks: static ((rows_c, K_c), ...) per network
    inv_perm: [n] int64 mapping original row -> position in the
              chunk-concatenated output; None = natural order
    colmajor: chunk slot layout, False = row-major (r*K + k), True =
              column-major (k*rows_c + r), which is what the fused df64
              reduction reads coalesced
    """

    masks: torch.Tensor  # [B, P, R, 128] int8, 8 stages bit-packed per plane
    vals: torch.Tensor
    kinds: Tuple[str, ...]
    dists: Tuple[int, ...]
    chunks: Tuple[Tuple[int, int], ...]
    inv_perm: Optional[torch.Tensor]
    shape: Tuple[int, int]
    m: int
    colmajor: bool = False


def _pow2_at_least(x: int) -> int:
    return 1 << int(np.ceil(np.log2(max(x, 2))))


def _fill_pads_with_missing(idx_all, b_e, t_e, ncol) -> None:
    """Assign pad slots' (don't-care, zero-product) gather values to each
    chunk net's MISSING column values: full value coverage empties the
    monotone schedule's concentrate phase (routenet._monotone_stages).
    Mutates idx_all in place."""
    B, m = idx_all.shape
    assigned = np.zeros((B, m), dtype=bool)
    assigned[b_e, t_e] = True
    for b in range(B):
        used = np.zeros(ncol, dtype=bool)
        used[idx_all[b][assigned[b]]] = True
        missing = np.nonzero(~used)[0]
        pads = np.nonzero(~assigned[b])[0]
        k = min(len(missing), len(pads))
        if k:
            idx_all[b, pads[:k]] = missing[:k]


def routed_csr_arrays(
    indptr: np.ndarray,
    indices: np.ndarray,
    data: np.ndarray,
    shape: Tuple[int, int],
    *,
    dtype: str = "f32",
    m: int | None = None,
    sort_rows="auto",
    verbose: bool = False,
    colmajor: bool = True,
    net_mode: str | None = None,
):
    """Host part of build_routed_csr: returns (net, vals, chunks, inv_perm,
    m) as numpy / Python, where net is the routenet.GatherPlanHost."""
    n, ncol = shape
    counts = np.diff(indptr).astype(np.int64)
    kmax = int(counts.max()) if n else 1
    if m is None:
        m = max(1024, _pow2_at_least(max(ncol, kmax)))
    if m < ncol or m < kmax:
        raise ValueError(
            f"table size m={m} must hold all {ncol} columns and the longest "
            f"row ({kmax})"
        )
    rd.check_table_feasible(m, what=f"single-table m={m}")

    if sort_rows == "auto":
        sort_rows = bool(kmax > 1.25 * max(counts.mean(), 1.0) + 2)
    order = np.argsort(-counts, kind="stable") if sort_rows else np.arange(n)
    if sort_rows and np.array_equal(order, np.arange(n)):
        sort_rows = False  # already length-sorted: no un-permute needed

    # greedy chunks over the (possibly unsorted) row order: each chunk's
    # K must cover the TRUE max length inside the chunk
    chunks = []
    i0 = 0
    while i0 < n:
        k_c = max(int(counts[order[i0]]), 1)
        rows_c = min(m // k_c, n - i0)
        k_true = max(int(counts[order[i0 : i0 + rows_c]].max()), 1)
        if k_true > k_c:
            rows_c = min(m // k_true, n - i0)
            k_c = max(int(counts[order[i0 : i0 + rows_c]].max()), 1)
        chunks.append((i0, rows_c, k_c))
        i0 += rows_c
    B = len(chunks)

    # vectorized slot assignment: entry e of row r -> (chunk_of[r],
    # row-major r_local*K + slot | column-major slot*rows_c + r_local)
    chunk_of = np.empty(n, dtype=np.int64)
    r_local = np.empty(n, dtype=np.int64)
    k_of_chunk = np.empty(B, dtype=np.int64)
    rowsc_of_chunk = np.empty(B, dtype=np.int64)
    for b, (i0, rows_c, k_c) in enumerate(chunks):
        chunk_of[order[i0 : i0 + rows_c]] = b
        r_local[order[i0 : i0 + rows_c]] = np.arange(rows_c)
        k_of_chunk[b] = k_c
        rowsc_of_chunk[b] = rows_c
    rows_rep = np.repeat(np.arange(n), counts)
    slot_in_row = np.arange(len(indices)) - np.repeat(indptr[:-1], counts)
    b_e = chunk_of[rows_rep]
    if colmajor:
        t_e = slot_in_row * rowsc_of_chunk[b_e] + r_local[rows_rep]
    else:
        t_e = r_local[rows_rep] * k_of_chunk[b_e] + slot_in_row

    idx_all = np.zeros((B, m), dtype=np.int64)
    idx_all[b_e, t_e] = indices
    if dtype == "df64":
        dvals = df.split_f64_np(data)
    else:
        dvals = data.astype({"f32": np.float32, "f64": np.float64}[dtype])
    vals = np.zeros((B, m) + dvals.shape[1:], dtype=dvals.dtype)
    vals[b_e, t_e] = dvals

    if net_mode is None:
        from lilac_tpu_torch.config import cfg as _cfg

        net_mode = _cfg().net_mode
    if net_mode == "monotone":
        _fill_pads_with_missing(idx_all, b_e, t_e, ncol)

    net = rn.build_gather_network(idx_all, ncol, m, mode=net_mode)
    if verbose:
        print(
            f"routed: n={n} m={m} chunks={B} stages={len(net.kinds)} "
            f"masks={net.masks.nbytes / 1e6:.0f}MB(bool)"
        )
    inv_perm = None
    if sort_rows:
        inv_perm = np.empty(n, dtype=np.int64)
        inv_perm[order] = np.arange(n)
    return net, vals, tuple((rc, kc) for _, rc, kc in chunks), inv_perm, m


def build_routed_csr(
    indptr, indices, data, shape, *, dtype: str = "f32", m: int | None = None,
    sort_rows="auto", verbose: bool = False, colmajor: bool = True,
    device="cuda",
) -> RoutedMat:
    """Stage a host CSR matrix as a RoutedMat (single column segment).

    m: network size (power of two multiple of 1024, >= ncols and >= the
    longest row; default = smallest such)."""
    net, vals, chunks, inv_perm, m = routed_csr_arrays(
        indptr, indices, data, shape, dtype=dtype, m=m, sort_rows=sort_rows,
        verbose=verbose, colmajor=colmajor,
    )
    return RoutedMat(
        masks=rd.masks_device(net, device),
        vals=torch.as_tensor(vals, device=device),
        kinds=net.kinds,
        dists=net.dists,
        chunks=chunks,
        inv_perm=None if inv_perm is None else torch.as_tensor(
            inv_perm, dtype=torch.int64, device=device),
        shape=tuple(shape),
        m=m,
        colmajor=colmajor,
    )


# ---------------------------------------------------------------------------
# matvecs
# ---------------------------------------------------------------------------


def _pad_plane(x: torch.Tensor, m: int) -> torch.Tensor:
    out = x.new_zeros(m)
    out[: x.shape[0]] = x
    return out.view(m // 128, 128)


def _chunk_reduce(prod_flat, chunks, m, colmajor=False):
    parts = []
    for c, (rows_c, k_c) in enumerate(chunks):
        p = prod_flat[c, : rows_c * k_c]
        if colmajor:
            parts.append(p.view(k_c, rows_c).sum(dim=0))
        else:
            parts.append(p.view(rows_c, k_c).sum(dim=1))
    return torch.cat(parts)


def _chunk_reduce_df(prod, chunks, colmajor=False):
    """df64 single-table ELL row sums by the op chain -> (hi, lo)
    concatenated 1D tensors."""
    his, los = [], []
    for c, (rows_c, k_c) in enumerate(chunks):
        with _MULRED:
            h, l_ = dfk.chunk_reduce_net_df(
                df.DF(prod.hi[c], prod.lo[c]), ((0, rows_c, k_c),), colmajor
            )
        his.append(h)
        los.append(l_)
    return torch.cat(his), torch.cat(los)


@functools.lru_cache(maxsize=64)
def _single_table_k2(chunks, m: int) -> dfk.ChunkTable:
    """K2's table of a single-table plan (built once per plan): chunk c is
    net-row c's leading rows_c * k_c slots of the [B * m] planes."""
    spec, row0 = [], 0
    for c, (rows_c, k_c) in enumerate(chunks):
        spec.append((c * m, rows_c, k_c, row0))
        row0 += rows_c
    return dfk.ChunkTable(spec)


def _mulreduce_df_2d(vals, oh, ol, chunks, m: int, colmajor: bool):
    """df64 mul+row-sum for the [B, m] single-table and segment containers:
    chunk c is net-row c's leading rows_c * k_c slots. Column-major plans
    take the fused kernel, all chunks in one launch; row-major plans the op
    chain."""
    if colmajor:
        v = vals.reshape(-1, 2)
        with _MULRED:
            return dfk.dfmulred_chunks(v[:, 0], v[:, 1], oh.reshape(-1),
                                       ol.reshape(-1), _single_table_k2(chunks, m))
    prod = df.mul(df.DF(vals[..., 0], vals[..., 1]), df.DF(oh, ol))
    return _chunk_reduce_df(prod, chunks, colmajor)


def routed_spmv(A: RoutedMat, x: torch.Tensor) -> torch.Tensor:
    with _ROUTE:
        (out,) = rd.routed_apply(
            [_pad_plane(x.to(A.vals.dtype), A.m)], A.masks, A.kinds, A.dists
        )
    prod = A.vals * out.view(len(A.chunks), A.m)
    y = _chunk_reduce(prod, A.chunks, A.m, A.colmajor)
    if A.inv_perm is not None:
        y = y[A.inv_perm]
    return y[: A.shape[0]]


def routed_spmv_df(A: RoutedMat, x: df.DF) -> df.DF:
    with _ROUTE:
        oh, ol = rd.routed_apply(
            [_pad_plane(x.hi, A.m), _pad_plane(x.lo, A.m)],
            A.masks, A.kinds, A.dists,
        )
    B = len(A.chunks)
    hi, lo = _mulreduce_df_2d(A.vals, oh.view(B, A.m), ol.view(B, A.m), A.chunks,
                              A.m, A.colmajor)
    if A.inv_perm is not None:
        hi, lo = hi[A.inv_perm], lo[A.inv_perm]
    return df.DF(hi[: A.shape[0]], lo[: A.shape[0]])


def _expand_chunk(dst, src, rows_c: int, k_c: int, colmajor: bool) -> None:
    """Adjoint of one chunk's row sums, in place: dst [.., rows_c * k_c]
    slots <- src [.., rows_c] row cotangents, each tiled over its row's k_c
    slots. One copy, whatever the count of leading axes."""
    lead = dst.shape[:-1]
    if colmajor:
        dst.view(*lead, k_c, rows_c).copy_(src.unsqueeze(-2).expand(*lead, k_c, rows_c))
    else:
        dst.view(*lead, rows_c, k_c).copy_(src.unsqueeze(-1).expand(*lead, rows_c, k_c))


def _adj_slots(A: RoutedMat, us: torch.Tensor) -> torch.Tensor:
    """us [P, n] sorted row cotangents -> [P, B, m] slot order (pads zero)."""
    sl = us.new_zeros((us.shape[0], len(A.chunks), A.m))
    off = 0
    for c, (rows_c, k_c) in enumerate(A.chunks):
        _expand_chunk(sl[:, c, : rows_c * k_c], us[:, off : off + rows_c],
                      rows_c, k_c, A.colmajor)
        off += rows_c
    return sl


def _adj_sorted(A: RoutedMat, u: torch.Tensor) -> torch.Tensor:
    """Adjoint of the final row un-permute: u [P, >= n] natural order ->
    [P, n] in the chunk-concatenated order."""
    n = A.shape[0]
    if A.inv_perm is None:
        return u[:, :n]
    us = u.new_zeros((u.shape[0], n))
    us[:, A.inv_perm] = u[:, :n]
    return us


def routed_spmv_adj_t(A: RoutedMat, u: torch.Tensor) -> torch.Tensor:
    """y = Aᵀ u through the FORWARD plan's own masks (plain floats): the
    gather network run in reverse with add-merges (kernel K11). No second
    network, no transposed copy of the matrix."""
    B, R = len(A.chunks), A.m // 128
    sl = _adj_slots(A, _adj_sorted(A, u.unsqueeze(0)))[0]
    prod = (A.vals * sl).to(u.dtype)
    with _ROUTE:
        (out,) = rd.routed_apply_t([prod.view(B, R, 128)], A.masks, A.kinds, A.dists)
    return out.view(B, A.m).sum(dim=0)[: A.shape[1]]


def routed_spmv_adj_t_df(A: RoutedMat, u: df.DF) -> df.DF:
    """df64 y = Aᵀ u through the forward plan's masks: TwoProd by the slot
    values, the reverse network's merges compensated in the kernel, df sum
    over the nets. A column-major plan on a card takes kernels/dfadj.py's
    two kernels around the network, K2's table for its slots."""
    B, R = len(A.chunks), A.m // 128
    us = _adj_sorted(A, torch.stack([u.hi, u.lo]))
    fused = _dfadj_takes(A, us)
    if fused:
        v = A.vals.reshape(-1, 2)
        prod = dfadj.slots_mul(v[:, 0], v[:, 1], us[0], us[1],
                               _single_table_k2(A.chunks, A.m))
    else:
        sl = _adj_slots(A, us)
        prod = df.mul(df.DF(A.vals[..., 0], A.vals[..., 1]), df.DF(sl[0], sl[1]))
    with _ROUTE:
        oh, ol = rd.routed_apply_t(
            [prod.hi.view(B, R, 128), prod.lo.view(B, R, 128)],
            A.masks, A.kinds, A.dists, dfpair=True)
    y = (dfadj.netsum if fused else dfadj.netsum_plain)(oh.view(B, A.m), ol.view(B, A.m))
    return df.DF(y.hi[: A.shape[1]], y.lo[: A.shape[1]])


def _dfadj_takes(A, us: torch.Tensor) -> bool:
    """Whether a df64 adjoint runs kernels/dfadj.py's kernels: for a
    column-major plan on a card, as the forward product takes K2; the op
    chains else."""
    return A.colmajor and us.is_cuda


# ---------------------------------------------------------------------------
# column-segmented routing (a matrix whose x exceeds one network table)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RoutedMatSeg:
    """Column-segmented RoutedMat: one single-table network group a column
    segment of seg_size (= m) columns.

    All segments share ONE global row order (descending total degree), so
    their chunk-concatenated partial sums align; y accumulates over the
    segments in sorted order and one [n] pair-gather by inv_perm (row ->
    position in that order) restores the natural order at the end."""

    masks: tuple  # per segment [B_s, P_s, R, 128] int8
    vals: tuple  # per segment [B_s, m] (or [B_s, m, 2] df64)
    kinds: Tuple[Tuple[str, ...], ...]
    dists: Tuple[Tuple[int, ...], ...]
    chunks: Tuple[Tuple[Tuple[int, int], ...], ...]
    inv_perm: torch.Tensor  # [n] int64
    shape: Tuple[int, int]
    m: int
    seg_size: int
    colmajor: bool = False  # see RoutedMat.colmajor


def build_routed_csr_seg(
    indptr: np.ndarray,
    indices: np.ndarray,
    data: np.ndarray,
    shape: Tuple[int, int],
    *,
    dtype: str = "f32",
    seg_size: int = 1 << 18,
    verbose: bool = False,
    colmajor: bool = True,
    device="cuda",
) -> RoutedMatSeg:
    """Stage a host CSR as column-segmented routing networks on `device`,
    bit-identical to the JAX package's builder. The entries of a row must be
    column-sorted (canonical CSR). A segment's table is checked as a single
    table of m = seg_size slots (check_table_feasible) of at most 2^18
    slots, and the card's shared memory must take a tile of the kernel for
    the plan's words (routed_tile)."""
    n, ncol = shape
    m = seg_size
    if m > SINGLE_TABLE_MAX:
        raise ValueError(f"segment of {m} columns: at most {SINGLE_TABLE_MAX}")
    rd.check_table_feasible(m, what=f"seg-table m={m}")
    nplanes, esize = (2, 4) if dtype == "df64" else (1, 8 if dtype == "f64" else 4)
    limit = rd.smem_optin_bytes(device)
    rd.check_tile(rd.routed_tile(nplanes, esize, limit), nplanes, esize, limit)
    nseg = -(-ncol // seg_size)
    counts = np.diff(indptr).astype(np.int64)
    order = np.argsort(-counts, kind="stable")
    rank = np.empty(n, dtype=np.int64)
    rank[order] = np.arange(n)

    if dtype == "df64":
        dvals = df.split_f64_np(data)
    else:
        dvals = data.astype({"f32": np.float32, "f64": np.float64}[dtype])

    rows_rep = np.repeat(np.arange(n), counts)
    seg_of = indices // seg_size
    # per (row, segment) counts and the slot of each entry inside its run
    rs_counts = np.zeros((n, nseg), dtype=np.int64)
    np.add.at(rs_counts, (rows_rep, seg_of), 1)
    run_key = rows_rep * nseg + seg_of
    run_start = np.zeros(len(indices), dtype=bool)
    if len(indices):
        run_start[0] = True
        run_start[1:] = run_key[1:] != run_key[:-1]
    run_id = np.cumsum(run_start) - 1
    first_of_run = np.zeros(run_id[-1] + 1 if len(indices) else 0, dtype=np.int64)
    first_of_run[run_id[run_start]] = np.nonzero(run_start)[0]
    slot_in_run = np.arange(len(indices)) - first_of_run[run_id]

    from lilac_tpu_torch.config import cfg as _cfg

    mode = _cfg().net_mode
    seg_masks, seg_vals, seg_kinds, seg_dists, seg_chunks = [], [], [], [], []
    for s in range(nseg):
        cs = rs_counts[order, s]  # per-row segment counts in the global order
        # greedy chunks over the shared order; K = the max count inside a
        # chunk (counts are not monotone in this order)
        chunks = []
        i0 = 0
        while i0 < n:
            k_c = max(int(cs[i0]), 1)
            rows_c = min(m // k_c, n - i0)
            k_true = int(cs[i0 : i0 + rows_c].max())
            if k_true > k_c:
                rows_c = min(m // k_true, n - i0)
                k_c = int(cs[i0 : i0 + rows_c].max())
            else:
                k_c = k_true if k_true else 1
            chunks.append((i0, rows_c, k_c))
            i0 += rows_c
        B = len(chunks)
        chunk_of = np.empty(n, dtype=np.int64)
        r_local = np.empty(n, dtype=np.int64)
        k_of_chunk = np.empty(B, dtype=np.int64)
        for b, (i0, rows_c, k_c) in enumerate(chunks):
            chunk_of[order[i0 : i0 + rows_c]] = b
            r_local[order[i0 : i0 + rows_c]] = np.arange(rows_c)
            k_of_chunk[b] = k_c
        sel = seg_of == s
        rr = rows_rep[sel]
        b_e = chunk_of[rr]
        if colmajor:
            rowsc_of = np.array([rc for _, rc, _ in chunks], dtype=np.int64)
            t_e = slot_in_run[sel] * rowsc_of[b_e] + r_local[rr]
        else:
            t_e = r_local[rr] * k_of_chunk[b_e] + slot_in_run[sel]
        idx_all = np.zeros((B, m), dtype=np.int64)
        idx_all[b_e, t_e] = indices[sel] - s * seg_size
        vals = np.zeros((B, m) + dvals.shape[1:], dtype=dvals.dtype)
        vals[b_e, t_e] = dvals[sel]
        ncol_s = min(seg_size, ncol - s * seg_size)
        if mode == "monotone":
            _fill_pads_with_missing(idx_all, b_e, t_e, ncol_s)
        net = rn.build_gather_network(idx_all, ncol_s, m, mode=mode)
        if verbose:
            print(f"  seg {s}: chunks={B} stages={len(net.kinds)} "
                  f"masks={net.masks.nbytes / 1e6:.0f}MB(bool)", flush=True)
        seg_masks.append(rd.masks_device(net, device))
        seg_vals.append(torch.as_tensor(vals, device=device))
        seg_kinds.append(net.kinds)
        seg_dists.append(net.dists)
        seg_chunks.append(tuple((rc, kc) for _, rc, kc in chunks))

    return RoutedMatSeg(
        masks=tuple(seg_masks), vals=tuple(seg_vals), kinds=tuple(seg_kinds),
        dists=tuple(seg_dists), chunks=tuple(seg_chunks),
        inv_perm=torch.as_tensor(rank, dtype=torch.int64, device=device),
        shape=tuple(shape), m=m, seg_size=seg_size, colmajor=colmajor,
    )


def _seg_planes(x: torch.Tensor, A: RoutedMatSeg) -> torch.Tensor:
    """x zero-padded to nseg * m words, [nseg, R, 128]: plane s is segment
    s's slice of x (contiguous, so aligned as K1 needs)."""
    nseg = len(A.masks)
    xp = x.new_zeros(nseg * A.m)
    xp[: x.shape[0]] = x
    return xp.view(nseg, A.m // 128, 128)


def routed_seg_spmv(A: RoutedMatSeg, x: torch.Tensor) -> torch.Tensor:
    """y = A x: K1 on each segment's slice of x, its chunk row sums, the
    segments summed in order, then one gather by inv_perm."""
    xs = _seg_planes(x.to(A.vals[0].dtype), A)
    y = None
    for s in range(len(A.masks)):
        with _ROUTE:
            (out,) = rd.routed_apply([xs[s]], A.masks[s], A.kinds[s], A.dists[s])
        t = _chunk_reduce(A.vals[s] * out.view(len(A.chunks[s]), A.m),
                          A.chunks[s], A.m, A.colmajor)
        y = t if y is None else y + t
    from lilac_tpu_torch.kernels.gather import pair_gather

    return pair_gather(y, A.inv_perm)


def routed_seg_spmv_df(A: RoutedMatSeg, x: df.DF) -> df.DF:
    """df64 y = A x: K1 on the hi and lo planes of each segment, K2 on the
    segment's chunk table (the op chain for a row-major plan), the segments
    combined by a compensated df.add in order, then one gather by
    inv_perm."""
    hs, ls = _seg_planes(x.hi, A), _seg_planes(x.lo, A)
    y = None
    for s in range(len(A.masks)):
        with _ROUTE:
            oh, ol = rd.routed_apply([hs[s], ls[s]], A.masks[s], A.kinds[s],
                                     A.dists[s])
        B = len(A.chunks[s])
        t = df.DF(*_mulreduce_df_2d(A.vals[s], oh.view(B, A.m), ol.view(B, A.m),
                                    A.chunks[s], A.m, A.colmajor))
        # every segment reaches every row: the compensated add keeps the
        # (hi, lo) pair non-overlapping across the segment merge
        y = t if y is None else df.add(y, t)
    ys = torch.stack([y.hi, y.lo], dim=-1)[A.inv_perm]
    return df.DF(ys[:, 0], ys[:, 1])



# ---------------------------------------------------------------------------
# plan files (the JAX package's npz format)
# ---------------------------------------------------------------------------

_CACHE_VERSION = 2


def _savez_atomic(path: str, **kv) -> None:
    """np.savez via a per-process temp + os.replace: a concurrent reader can
    never see a torn zip, and two writers last-win whole files instead of
    interleaving. The temp name is dot-prefixed so plan-cache globs never
    match an in-progress write; stale temps of dead writers are swept."""
    d, base = os.path.split(path)
    for old in glob.glob(os.path.join(d, f".tmp_*_{base}")):
        try:
            # a recycled PID can pin a dead writer's temp forever: no plan
            # savez takes hours, so a 6h-old temp is stale whatever its pid
            if time.time() - os.path.getmtime(old) > 6 * 3600:
                os.unlink(old)
                continue
        except OSError:
            pass
        try:
            owner = int(os.path.basename(old).split("_", 2)[1])
            os.kill(owner, 0)  # raises if owner is gone
        except (ValueError, IndexError, ProcessLookupError):
            try:
                os.unlink(old)
            except OSError:
                pass
        except OSError:
            pass  # pid exists but isn't ours: leave it alone
    # must end in .npz or np.savez appends the suffix
    tmp = os.path.join(d, f".tmp_{os.getpid()}_{base}")
    try:
        np.savez(tmp, **kv)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _detuple(x):
    if isinstance(x, list):
        return tuple(_detuple(v) for v in x)
    return x


def _save_hier(path: str, M: "RoutedMatHier") -> None:
    kv = {"version": _CACHE_VERSION, "cls": "RoutedMatHier",
          "shape": np.asarray(M.shape), "m": M.m}
    kv["meta"] = json.dumps({
        "chunks": M.chunks,
        "m_out": M.m_out,
        "bl": M.bl,
        "n_nz": M.n_nz,
        "colmajor": bool(M.colmajor),
        "nets_meta": [net.pass_meta for net in M.nets],
        "unperm_meta": M.unperm.pass_meta if M.unperm is not None else None,
        "nets_npass": [len(net.pass_masks) for net in M.nets],
    })
    for i, net in enumerate(M.nets):
        kv[f"vals{i}"] = _np(M.vals[i])
        for j, mk in enumerate(net.pass_masks):
            kv[f"net{i}_mask{j}"] = _np(mk)
    for j, mk in enumerate(M.unperm.pass_masks if M.unperm is not None else ()):
        kv[f"unperm_mask{j}"] = _np(mk)
    _savez_atomic(path, **kv)


def _hier_words(vals) -> Tuple[int, int]:
    """(planes, bytes a word) that a hier plan's networks route: df64 values
    [m, 2] go as a (hi, lo) pair of f32 planes."""
    v = vals[0]
    return (2, 4) if v.ndim == 2 else (1, int(v.dtype.itemsize))


def _load_hier(path: str, z, device) -> "RoutedMatHier":
    meta = json.loads(str(z["meta"]))
    # masks and vals stay HOST numpy here: pack_hier stacks on the host and
    # uploads each stacked pass once, so the plan is never twice on the card
    nets, vals = [], []
    for i, npass in enumerate(meta["nets_npass"]):
        nets.append(HierNet(
            pass_masks=tuple(np.asarray(z[f"net{i}_mask{j}"]) for j in range(npass)),
            pass_meta=_detuple(meta["nets_meta"][i]),
        ))
        vals.append(np.asarray(z[f"vals{i}"]))
    unperm = None
    if meta["unperm_meta"] is not None:
        umeta = _detuple(meta["unperm_meta"])
        unperm = HierNet(
            pass_masks=tuple(np.asarray(z[f"unperm_mask{j}"]) for j in range(len(umeta))),
            pass_meta=umeta,
        )
    # a plan written for another machine (the JAX package's default block is
    # 2^16 slots) may not fit this card's shared memory: refuse at load
    nplanes, esize = _hier_words(vals) if vals else (1, 4)
    for net in nets + ([unperm] if unperm is not None else []):
        rd.check_smem_feasible(
            net.pass_meta, int(meta["bl"]), nplanes, esize,
            limit=rd.smem_optin_bytes(device), what=f"cached hier plan {path}")
    return RoutedMatHier(
        nets=tuple(nets), vals=tuple(vals), unperm=unperm,
        chunks=_detuple(meta["chunks"]),
        shape=tuple(int(v) for v in z["shape"]), m=int(z["m"]),
        m_out=int(meta["m_out"]), bl=int(meta["bl"]), n_nz=int(meta["n_nz"]),
        # plans from before the column-major layout carry no flag
        colmajor=bool(meta.get("colmajor", False)),
    )


def _save_seg(path: str, M: RoutedMatSeg) -> None:
    kv = {"version": _CACHE_VERSION, "cls": "RoutedMatSeg",
          "shape": np.asarray(M.shape), "m": M.m, "colmajor": int(M.colmajor),
          "seg_size": M.seg_size, "nseg": len(M.masks),
          "inv_perm": _np(M.inv_perm).astype(np.int32)}
    for s in range(len(M.masks)):
        kv[f"masks{s}"] = _np(M.masks[s])
        kv[f"vals{s}"] = _np(M.vals[s])
        kv[f"kinds{s}"] = np.array(M.kinds[s])
        kv[f"dists{s}"] = np.asarray(M.dists[s])
        kv[f"chunks{s}"] = np.asarray(M.chunks[s])
    _savez_atomic(path, **kv)


def _load_seg(path: str, z, device) -> RoutedMatSeg:
    m = int(z["m"])
    rd.check_table_feasible(m, what=f"cached seg plan {path}")
    nseg = int(z["nseg"])
    return RoutedMatSeg(
        masks=tuple(torch.as_tensor(z[f"masks{s}"], device=device) for s in range(nseg)),
        vals=tuple(torch.as_tensor(z[f"vals{s}"], device=device) for s in range(nseg)),
        kinds=tuple(tuple(str(k) for k in z[f"kinds{s}"]) for s in range(nseg)),
        dists=tuple(tuple(int(d) for d in z[f"dists{s}"]) for s in range(nseg)),
        chunks=tuple(tuple((int(a), int(b)) for a, b in z[f"chunks{s}"])
                     for s in range(nseg)),
        inv_perm=torch.as_tensor(z["inv_perm"].astype(np.int64), device=device),
        shape=tuple(int(v) for v in z["shape"]), m=m, seg_size=int(z["seg_size"]),
        colmajor=bool(int(z["colmajor"])) if "colmajor" in z.files else False,
    )


def save_routed(path: str, M) -> None:
    """Write a RoutedMat, a RoutedMatSeg or a host-staged RoutedMatHier in the
    JAX package's npz format (hier plans per net, so packing happens after
    the save)."""
    if isinstance(M, RoutedMatHier):
        return _save_hier(path, M)
    if isinstance(M, RoutedMatSeg):
        return _save_seg(path, M)
    if not isinstance(M, RoutedMat):
        raise TypeError(
            f"save_routed takes a RoutedMat, a RoutedMatSeg or a host-staged "
            f"RoutedMatHier, got {type(M).__name__}")
    _savez_atomic(
        path,
        version=_CACHE_VERSION, cls="RoutedMat", shape=np.asarray(M.shape),
        m=M.m, colmajor=int(M.colmajor),
        masks=_np(M.masks), vals=_np(M.vals),
        kinds=np.array(M.kinds), dists=np.asarray(M.dists),
        chunks=np.asarray(M.chunks),
        inv_perm=(_np(M.inv_perm).astype(np.int32) if M.inv_perm is not None
                  else np.zeros(0, np.int32)),
    )


def load_routed(path: str, device="cuda"):
    """Load a plan file; None for another cache version. A RoutedMat or a
    RoutedMatSeg comes back on `device`. A RoutedMatHier comes back
    host-staged (numpy leaves; maybe_pack_hier uploads it) after its passes
    were checked against `device`'s shared memory: a plan whose block
    length does not fit raises ValueError."""
    z = np.load(path, allow_pickle=False)
    if int(z["version"]) != _CACHE_VERSION:
        return None
    cls = str(z["cls"])
    if cls == "RoutedMatHier":
        return _load_hier(path, z, device)
    if cls == "RoutedMatSeg":
        return _load_seg(path, z, device)
    if cls != "RoutedMat":
        raise ValueError(f"{path}: unknown plan class {cls!r}")
    # pre-colmajor caches carry no flag and are row-major
    cm = bool(int(z["colmajor"])) if "colmajor" in z.files else False
    inv = z["inv_perm"]
    m = int(z["m"])
    rd.check_table_feasible(m, what=f"cached plan {path}")
    return RoutedMat(
        masks=torch.as_tensor(z["masks"], device=device),
        vals=torch.as_tensor(z["vals"], device=device),
        kinds=tuple(str(k) for k in z["kinds"]),
        dists=tuple(int(d) for d in z["dists"]),
        chunks=tuple((int(a), int(b)) for a, b in z["chunks"]),
        inv_perm=(torch.as_tensor(inv.astype(np.int64), device=device)
                  if len(inv) else None),
        shape=tuple(int(v) for v in z["shape"]),
        m=m, colmajor=cm,
    )


SINGLE_TABLE_MAX = 1 << 18  # largest n the reference serves with one table

# what a damaged, truncated or foreign plan file raises while it is read
_LOAD_ERRORS = (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile)


def plan_tag(conf, hier: bool) -> str:
    """The geometry tag of a routed plan file name (the reference's cache
    schema v2 names). Single-table plans carry the net-mode tag (monotone
    schedules differ from Benes). Hier plans always build Benes and ALWAYS
    carry their (bl, gmax) tag: the port's default block length differs
    from the reference's, so an untagged name would alias a plan of another
    geometry."""
    if not hier:
        return "_m" if conf.net_mode == "monotone" else ""
    g = conf.hier_gmax if conf.hier_gmax is not None else "a"
    return f"_bl{hier_bl_cfg()}g{g}"


def _load_plans(paths, device):
    """The plan files as RoutedMats, RoutedMatSegs or host-staged
    RoutedMatHiers, or None when one is missing, unreadable, of another
    cache version, in the old row-major layout or infeasible on this
    device. Only errors of reading the files are caught here."""
    if not all(os.path.exists(p) for p in paths):
        return None
    try:
        # a single table is uploaded inside load_routed, a hier plan later
        with _READ(fence=device):
            plans = [load_routed(p, device=device) for p in paths]
    except _LOAD_ERRORS:
        return None
    if any(p is None for p in plans) or not plans[0].colmajor:
        return None
    return plans


# ---------------------------------------------------------------------------
# hierarchical routing: one full-size network per term super-block (no
# column segmentation: stage distances above the block length run as
# butterfly / window / bigshift passes, see kernels/routed.py)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class HierNet:
    """One network's compile_hier pass schedule.

    pass_masks: one mask array per pass, numpy while the plan is staged on
    the host (builder, load_routed), torch tensors once it is on a device.
    pass_meta: static ("inner", kinds, dists) | ("butterfly", bits) |
    ("bigshift", d) | ("window", dists), one per pass."""

    pass_masks: tuple
    pass_meta: tuple


def _split_hier(passes) -> HierNet:
    return HierNet(pass_masks=tuple(p[-1] for p in passes),
                   pass_meta=tuple(p[:-1] for p in passes))


def hier_net_apply(net: HierNet, planes, bl: int):
    """One net through the un-batched appliers (kernels K3u-K6u)."""
    passes = [m + (mk,) for m, mk in zip(net.pass_meta, net.pass_masks)]
    with _ROUTE:
        return rd.hier_apply(planes, passes, bl)


@dataclasses.dataclass
class RoutedMatHier:
    """Sparse matrix staged as hierarchical routing networks.

    nets[i] gathers x into net i's term slots; vals[i] [m(, 2)] multiplies
    in slot order; chunks[i] = ((slot0, rows_c, K_c), ...) describe the ELL
    sub-blocks packed into the net. Rows are globally sorted by length
    (tight K); `unperm` routes the chunk-concatenated sorted y back to
    natural order and is None when the rows came sorted. colmajor: slot
    layout inside a chunk, False = s0 + r*K + k, True = s0 + k*rows_c + r
    (what the fused df64 reduction reads coalesced).

    The builder and load_routed return it host-staged (numpy leaves);
    maybe_pack_hier puts it on a device as a RoutedMatHierP."""

    nets: tuple
    vals: tuple
    unperm: Optional[HierNet]
    chunks: tuple
    shape: Tuple[int, int]
    m: int
    m_out: int
    bl: int
    n_nz: int  # rows with nonzero count = length of the sorted concat
    colmajor: bool = False


@dataclasses.dataclass
class HierGroup:
    """A batch of hier nets sharing one pass schedule, masks stacked on a
    leading net axis (see rd.hier_apply_batched). vals are plane-shaped:
    [Ng, m//128, 128] (f32 / f64) or [2, Ng, m//128, 128] (df64; 0 = hi,
    1 = lo)."""

    pass_masks: tuple  # per pass: [Ng, ...] stacked device masks
    vals: torch.Tensor
    pass_meta: tuple  # static, shared by all Ng nets
    net_ids: tuple  # static: original net indices (row-order bookkeeping)


@dataclasses.dataclass
class RoutedMatHierP:
    """A hier plan on a device: RoutedMatHier with its nets packed into
    schedule groups, so each pass over a group is ONE kernel launch (grid
    over blocks x nets) instead of one per net. The plan file is unchanged
    (per-net masks); packing happens at build / load (maybe_pack_hier),
    stacked on the host so the upload is a few large transfers."""

    groups: tuple  # HierGroup
    unperm: Optional[HierNet]
    chunks: tuple  # per ORIGINAL net id (same as RoutedMatHier.chunks)
    shape: Tuple[int, int]
    m: int
    m_out: int
    bl: int
    n_nz: int
    colmajor: bool = False


def _net_to_device(net: Optional[HierNet], device) -> Optional[HierNet]:
    if net is None:
        return None
    return HierNet(
        pass_masks=tuple(torch.as_tensor(mk, device=device) for mk in net.pass_masks),
        pass_meta=net.pass_meta,
    )


def plan_bytes(M) -> int:
    """Bytes of a hier plan's masks and values (host-staged or on a device)."""
    if isinstance(M, RoutedMatHierP):
        nets, vals = M.groups, [g.vals for g in M.groups]
    else:
        nets, vals = M.nets, M.vals
    total = sum(mk.nbytes for net in nets for mk in net.pass_masks)
    total += sum(v.nbytes for v in vals)
    if M.unperm is not None:
        total += sum(mk.nbytes for mk in M.unperm.pass_masks)
    return total


def _group_cap(M: RoutedMatHier, device) -> Optional[int]:
    """Most nets a packed group may hold on `device`. A forward pass over a
    group holds its [Ng, m] input and output planes, and the final relayout
    a third copy. The adjoint product holds more before its first pass: the
    slot cotangents, their product with the values and, for df64, the
    TwoProd's intermediates, about six copies of the routed planes in all.
    The cap keeps six copies within half of the device memory that is free
    once the plan itself is resident. None (no cap) on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    nplanes, esize = _hier_words(M.vals)
    free, _ = torch.cuda.mem_get_info(device)
    per_net = 6 * M.m * nplanes * esize
    return max(1, int((free - plan_bytes(M)) // 2 // per_net))


def pack_hier(M: RoutedMatHier, device="cuda") -> RoutedMatHierP:
    """Group nets by identical pass schedule and stack their masks / vals on
    a leading net axis: a host-side stack, then one upload per pass. Groups
    are split where their pass intermediates would not fit the device
    (_group_cap)."""
    cap = _group_cap(M, device)
    order: list = []
    by_key: dict = {}
    for i, net in enumerate(M.nets):
        if net.pass_meta not in by_key:
            by_key[net.pass_meta] = []
            order.append(net.pass_meta)
        by_key[net.pass_meta].append(i)
    id_lists = []
    for key in order:
        ids = by_key[key]
        step = len(ids) if cap is None else cap
        id_lists += [(key, ids[g0 : g0 + step]) for g0 in range(0, len(ids), step)]
    R = M.m // 128
    groups = []
    for key, ids in id_lists:
        stacked = tuple(
            torch.as_tensor(
                np.stack([_np(M.nets[i].pass_masks[j]) for i in ids]), device=device)
            for j in range(len(key))
        )
        vh = np.stack([_np(M.vals[i]) for i in ids])  # [Ng, m(, 2)]
        if vh.ndim == 3:  # df64: split words, plane-shape each
            vh = np.stack([vh[..., 0].reshape(len(ids), R, 128),
                           vh[..., 1].reshape(len(ids), R, 128)])
        else:
            vh = vh.reshape(len(ids), R, 128)
        groups.append(HierGroup(
            pass_masks=stacked, vals=torch.as_tensor(vh, device=device),
            pass_meta=key, net_ids=tuple(ids)))
    return RoutedMatHierP(
        groups=tuple(groups), unperm=_net_to_device(M.unperm, device),
        chunks=M.chunks, shape=M.shape, m=M.m, m_out=M.m_out, bl=M.bl,
        n_nz=M.n_nz, colmajor=M.colmajor,
    )


def maybe_pack_hier(M, device="cuda"):
    """Put a host-staged hier plan on `device`, packed (pack_hier); anything
    that is not a RoutedMatHier passes through unchanged. The plan ends
    with exactly one copy on the device."""
    if not isinstance(M, RoutedMatHier):
        return M
    with _UPLOAD(fence=device):
        return pack_hier(M, device)


def hier_bl_cfg() -> int:
    """Block length of new hier plans: LILAC_HIER_BL, else the default
    derived from the card's shared memory (rd.default_hier_bl)."""
    from lilac_tpu_torch.config import cfg

    bl = cfg().hier_bl
    return int(bl) if bl is not None else rd.default_hier_bl()


def _hier_gmax_cfg(bl: int, dtype: str) -> int:
    """Butterfly group exponent: an explicit LILAC_HIER_GMAX wins, else
    rd.hier_gmax. A butterfly pass costs about one mask byte per slot
    whatever its stage count, so a larger g means fewer passes, smaller
    plans and fewer streams through device memory."""
    from lilac_tpu_torch.config import cfg

    g = cfg().hier_gmax
    if g is not None:
        return int(g)
    return rd.hier_gmax(bl, 2 if dtype == "df64" else 1)


def build_routed_csr_hier(
    indptr: np.ndarray,
    indices: np.ndarray,
    data: np.ndarray,
    shape: Tuple[int, int],
    *,
    dtype: str = "f32",
    bl: int | None = None,
    m: int | None = None,
    host_batch: int = 4,
    verbose: bool = False,
    colmajor: bool = True,
) -> RoutedMatHier:
    """Stage a host CSR matrix as a host-staged RoutedMatHier (all host
    work; maybe_pack_hier puts the result on a device). For one (bl, gmax)
    the arrays are bit-identical to the JAX package's builder. Nets are
    routed `host_batch` at a time; a batch's Benes colourings and pass
    compilations run on threads (the C router and numpy release the GIL)."""
    n, ncol = shape
    if bl is None:
        bl = hier_bl_cfg()
    counts = np.diff(indptr).astype(np.int64)
    kmax = int(counts.max()) if n else 1
    if m is None:
        m = max(2 * bl, _pow2_at_least(max(ncol, kmax)))
    if m < ncol or m % bl:
        raise ValueError(f"table size m={m} must hold {ncol} columns in blocks of {bl}")
    # fail on an infeasible bl / gmax BEFORE the expensive network build
    nplanes = 2 if dtype == "df64" else 1
    esize = 8 if dtype == "f64" else 4
    gmax = _hier_gmax_cfg(bl, dtype)
    rd.check_smem_feasible(
        (("butterfly", tuple(range(gmax))), ("window", ()), ("inner", (), ())),
        bl, nplanes, esize, what=f"hier bl={bl} gmax={gmax}",
    )

    order = np.argsort(-counts, kind="stable")
    sorted_counts = counts[order]
    n_nz = int(np.searchsorted(-sorted_counts, 0, side="left"))

    # pack (rows_c, K) chunks into m-slot nets; K = first (max) count in
    # chunk, rows capped where counts fall below 3/4 K to keep K tight
    nets_chunks = []  # per net: list of (slot0, rows_c, K)
    cur, used = [], 0
    i = 0
    while i < n_nz:
        K = int(sorted_counts[i])
        space = m - used
        if space < K:
            nets_chunks.append(cur)
            cur, used = [], 0
            continue
        lim = int(np.searchsorted(-sorted_counts, -max(1, (3 * K) // 4), side="right"))
        rows_c = min(space // K, n_nz - i, max(lim - i, 1))
        cur.append((used, rows_c, K))
        used += rows_c * K
        i += rows_c
    if cur:
        nets_chunks.append(cur)
    nnets = len(nets_chunks)

    if dtype == "df64":
        dvals = df.split_f64_np(data)
    else:
        dvals = data.astype({"f32": np.float32, "f64": np.float64}[dtype])

    # slot assignment (vectorized): entry e of row r -> net / slot. Row-major
    # chunks put entry k of local row r at s0 + r*K + k, column-major at
    # s0 + k*rows_c + r
    net_of = np.zeros(n, dtype=np.int64)
    slot0_of = np.zeros(n, dtype=np.int64)
    stride_of = np.ones(n, dtype=np.int64)
    pos = 0
    for b, chlist in enumerate(nets_chunks):
        for (s0, rows_c, K) in chlist:
            rows_b = order[pos : pos + rows_c]
            net_of[rows_b] = b
            if colmajor:
                slot0_of[rows_b] = s0 + np.arange(rows_c)
                stride_of[rows_b] = rows_c
            else:
                slot0_of[rows_b] = s0 + np.arange(rows_c) * K
            pos += rows_c
    rows_rep = np.repeat(np.arange(n), counts)
    slot_in_row = np.arange(len(indices)) - np.repeat(indptr[:-1], counts)
    b_e = net_of[rows_rep]
    t_e = slot0_of[rows_rep] + slot_in_row * stride_of[rows_rep]

    # padding slots gather (slot % ncol): bounded broadcast runs, value 0
    idx_all = np.tile(np.arange(m, dtype=np.int64) % ncol, (nnets, 1))
    idx_all[b_e, t_e] = indices
    vals = np.zeros((nnets, m) + dvals.shape[1:], dtype=dvals.dtype)
    vals[b_e, t_e] = dvals

    def compile_nets(net_h):
        B = net_h.masks.shape[1]

        def one(b):
            return _split_hier(rd.compile_hier(
                net_h.kinds, net_h.dists, net_h.masks[:, b, :], bl, gmax=gmax))

        if B == 1:
            return [one(0)]
        with ThreadPoolExecutor(max_workers=min(B, os.cpu_count() or 1)) as pool:
            return list(pool.map(one, range(B)))

    nets = []
    for g0 in range(0, nnets, host_batch):
        g1 = min(g0 + host_batch, nnets)
        net_h = rn.build_gather_network(idx_all[g0:g1], ncol, m, drop_empty=False)
        nets += compile_nets(net_h)
        if verbose:
            print(f"  hier nets {g0}..{g1 - 1}/{nnets} built", flush=True)

    # un-permute network: y_nat[r] = y_sorted[rank[r]]; zero-count rows read
    # the zero pad slot n_nz. When the matrix is already stored in
    # length-sorted row order the un-permute is the identity and is skipped.
    rank = np.full(n, n_nz, dtype=np.int64)
    rank[order[:n_nz]] = np.arange(n_nz)
    m_out = max(2 * bl, _pow2_at_least(max(n, n_nz + 1)))
    if np.array_equal(order[:n_nz], np.arange(n_nz)):
        unperm = None
    else:
        unet = rn.build_gather_network(rank[None], n_nz + 1, m_out, drop_empty=False)
        (unperm,) = compile_nets(unet)
    # the passes as compiled (the adjoint window's need depends on its shifts)
    for net in nets + ([unperm] if unperm is not None else []):
        rd.check_smem_feasible(net.pass_meta, bl, nplanes, esize,
                               what=f"hier bl={bl} gmax={gmax}")
    if verbose:
        print(f"hier: n={n} m={m} bl={bl} gmax={gmax} nets={nnets} "
              f"slots/nnz={nnets * m / max(len(indices), 1):.2f}", flush=True)
    return RoutedMatHier(
        nets=tuple(nets), vals=tuple(vals), unperm=unperm,
        chunks=tuple(tuple(ch) for ch in nets_chunks), shape=tuple(shape),
        m=m, m_out=m_out, bl=bl, n_nz=n_nz, colmajor=colmajor,
    )


def _chunk_reduce_net(prod_1d, chlist, colmajor=False):
    """Per-net ELL sub-block row sums: prod [m] -> concatenated row sums."""
    segs = [
        prod_1d[s0 : s0 + rows_c * K]
        .view((K, rows_c) if colmajor else (rows_c, K))
        .sum(dim=0 if colmajor else 1)
        for (s0, rows_c, K) in chlist
    ]
    return segs[0] if len(segs) == 1 else torch.cat(segs)


def _pad_to(y: torch.Tensor, n: int) -> torch.Tensor:
    return y if y.shape[0] == n else torch.nn.functional.pad(y, (0, n - y.shape[0]))


def _require_device_plan(A) -> None:
    if not isinstance(A, RoutedMatHierP):
        raise TypeError(
            "hier plan is staged on the host (numpy): put it on a device with "
            "maybe_pack_hier(M, device) first")


def _hier_unperm(A, ys):
    """Sorted chunk-concatenated row sums -> natural row order (the unperm
    network through the un-batched appliers), cut or padded to n rows."""
    n = A.shape[0]
    if A.unperm is None:
        return tuple(_pad_to(y, n) for y in ys)
    outs = hier_net_apply(
        A.unperm, tuple(_pad_plane(y, A.m_out) for y in ys), A.bl)
    return tuple(u.reshape(A.m_out)[:n] for u in outs)


def routed_hier_spmv(A: RoutedMatHierP, x: torch.Tensor) -> torch.Tensor:
    """y = A x for a hier plan, group by group (kernels K3-K6), plain
    floats."""
    _require_device_plan(A)
    xp = _pad_plane(x.to(A.groups[0].vals.dtype), A.m)
    parts = [None] * len(A.chunks)
    for grp in A.groups:
        with _ROUTE:
            (o,) = rd.hier_apply_batched((xp,), grp.pass_meta, grp.pass_masks, A.bl)
        prod = grp.vals * o  # both [Ng, m//128, 128]
        for li, ni in enumerate(grp.net_ids):
            parts[ni] = _chunk_reduce_net(
                prod[li].reshape(A.m), A.chunks[ni], A.colmajor)
    return _hier_unperm(A, (torch.cat(parts),))[0]


@functools.lru_cache(maxsize=64)
def _hier_k2(chunks, groups, m: int) -> tuple:
    """K2's table of each launch group of a hier plan (built once per plan):
    net ids[li] of a group holds its chunks at slots li * m + s0 of the
    group's [Ng * m] planes, and its row sums go where the chunk-concatenated
    sorted output of all nets puts them."""
    offs = np.concatenate([[0], np.cumsum(_hier_net_rows(chunks))])
    tables = []
    for net_ids in groups:
        spec = []
        for li, ni in enumerate(net_ids):
            row0 = int(offs[ni])
            for s0, rows_c, K in chunks[ni]:
                spec.append((li * m + s0, rows_c, K, row0))
                row0 += rows_c
        tables.append(dfk.ChunkTable(spec))
    return tuple(tables)


def _k2_outputs(tables, like: torch.Tensor):
    """The (hi, lo) planes every launch group's K2 writes its rows into."""
    rows = max(t.rows for t in tables)
    return tuple(torch.empty(rows, dtype=torch.float32, device=like.device)
                 for _ in range(2))


def routed_hier_spmv_df(A: RoutedMatHierP, x: df.DF) -> df.DF:
    """df64 y = A x for a hier plan: the (hi, lo) planes go through
    identical switches a group at a time, then the multiply + row sum. A
    column-major plan takes K2 (kernels/dfmulred.py), one launch a group
    into one pair of output planes; a row-major plan the op chain, net by
    net."""
    _require_device_plan(A)
    planes = (_pad_plane(x.hi, A.m), _pad_plane(x.lo, A.m))
    if not A.colmajor:
        nnets = len(A.chunks)
        parts_h, parts_l = [None] * nnets, [None] * nnets
        for grp in A.groups:
            with _ROUTE:
                oh, ol = rd.hier_apply_batched(planes, grp.pass_meta, grp.pass_masks,
                                               A.bl)
            for li, ni in enumerate(grp.net_ids):
                with _MULRED:
                    parts_h[ni], parts_l[ni] = dfk.chunk_mulreduce_df(
                        (grp.vals[0, li].reshape(A.m), grp.vals[1, li].reshape(A.m)),
                        oh[li].reshape(A.m), ol[li].reshape(A.m),
                        A.chunks[ni], A.colmajor)
        return df.DF(*_hier_unperm(A, (torch.cat(parts_h), torch.cat(parts_l))))
    tables = _hier_k2(A.chunks, tuple(g.net_ids for g in A.groups), A.m)
    out = _k2_outputs(tables, planes[0])
    for grp, table in zip(A.groups, tables):
        with _ROUTE:
            oh, ol = rd.hier_apply_batched(planes, grp.pass_meta, grp.pass_masks, A.bl)
        with _MULRED:
            out = dfk.dfmulred_chunks(grp.vals[0].reshape(-1), grp.vals[1].reshape(-1),
                                      oh.reshape(-1), ol.reshape(-1), table, out)
    return df.DF(*_hier_unperm(A, out))


# ---------------------------------------------------------------------------
# hierarchical adjoint matvecs: Aᵀu through the FORWARD plan run in reverse
# (rd.hier_apply_batched_t, kernels K7-K10). One hier plan serves both
# product directions, which halves the plan bytes of a factored operator.
# ---------------------------------------------------------------------------


def _hier_net_rows(chunks) -> list:
    """Per-net output row counts (the chunk-concatenated sorted space)."""
    return [sum(rc for _, rc, _ in chlist) for chlist in chunks]


def _expand_net_slots(dst, useg, chlist, colmajor) -> None:
    """Adjoint of _chunk_reduce_net, in place: tile one net's row cotangents
    useg [.., rows of this net] over their ELL slots in dst [.., m], which
    comes zeroed (gaps and pad slots carry zero values, so they contribute
    nothing after the multiply)."""
    off = 0
    for (s0, rows_c, K) in chlist:
        _expand_chunk(dst[..., s0 : s0 + rows_c * K], useg[..., off : off + rows_c],
                      rows_c, K, colmajor)
        off += rows_c


def _hier_adj_unperm(A, u: torch.Tensor, dfpair: bool) -> torch.Tensor:
    """Adjoint of the un-permute net (or of the trailing zero-pad when the
    rows came length-sorted): u [P, n] cotangent planes -> [P, n_nz] in the
    sorted space."""
    if A.unperm is None:
        return u[:, : A.n_nz]
    with _ROUTE:
        outs = rd.hier_apply_batched_t(
            tuple(_pad_plane(p, A.m_out).unsqueeze(0) for p in u),
            A.unperm.pass_meta,
            tuple(mk.unsqueeze(0) for mk in A.unperm.pass_masks),
            A.bl, dfpair=dfpair)
    return torch.stack([o.reshape(A.m_out)[: A.n_nz] for o in outs])


def _hier_adj_slots(A, us, net_ids):
    """us [P, n_nz] -> [P, Ng, m] slot cotangents of one group's nets."""
    offs = np.concatenate([[0], np.cumsum(_hier_net_rows(A.chunks))])
    sl = us.new_zeros((us.shape[0], len(net_ids), A.m))
    for li, ni in enumerate(net_ids):
        _expand_net_slots(sl[:, li], us[:, offs[ni] : offs[ni + 1]],
                          A.chunks[ni], A.colmajor)
    return sl


def routed_hier_spmv_adj_t(A: RoutedMatHierP, u: torch.Tensor) -> torch.Tensor:
    """y = Aᵀ u for a hier plan (plain floats): every net's network in
    reverse (kernels K7-K10), summed over the nets."""
    _require_device_plan(A)
    R = A.m // 128
    us = _hier_adj_unperm(A, u[: A.shape[0]].unsqueeze(0), False)
    y = None
    for grp in A.groups:
        N = len(grp.net_ids)
        sl = _hier_adj_slots(A, us, grp.net_ids)[0]
        prod = (grp.vals.reshape(N, A.m) * sl).to(u.dtype)
        with _ROUTE:
            (o,) = rd.hier_apply_batched_t(
                (prod.reshape(N, R, 128),), grp.pass_meta, grp.pass_masks, A.bl)
        t = o.sum(dim=0).reshape(A.m)
        y = t if y is None else y + t
    return y[: A.shape[1]]


def routed_hier_spmv_adj_t_df(A: RoutedMatHierP, u: df.DF) -> df.DF:
    """df64 y = Aᵀ u for a hier plan: expand the row cotangents to slots,
    TwoProd by the slot-ordered values (a whole group at once), every net's
    network in reverse with compensated merges, df sum over the nets and
    the groups. A column-major plan on a card takes kernels/dfadj.py's two
    kernels around the network, each group's K2 table for its slots; a
    row-major plan the op chains (_group_cap leaves room for their
    intermediates)."""
    _require_device_plan(A)
    R = A.m // 128
    n = A.shape[0]
    us = _hier_adj_unperm(A, torch.stack([u.hi[:n], u.lo[:n]]), True)
    fused = _dfadj_takes(A, us)
    if fused:
        tables = _hier_k2(A.chunks, tuple(g.net_ids for g in A.groups), A.m)
    y = None
    for gi, grp in enumerate(A.groups):
        N = len(grp.net_ids)
        if fused:
            prod = dfadj.slots_mul(grp.vals[0].reshape(-1), grp.vals[1].reshape(-1),
                                   us[0], us[1], tables[gi])
        else:
            sl = _hier_adj_slots(A, us, grp.net_ids)
            prod = df.mul(df.DF(grp.vals[0].reshape(N, A.m), grp.vals[1].reshape(N, A.m)),
                          df.DF(sl[0], sl[1]))
            del sl
        with _ROUTE:
            oh, ol = rd.hier_apply_batched_t(
                (prod.hi.reshape(N, R, 128), prod.lo.reshape(N, R, 128)),
                grp.pass_meta, grp.pass_masks, A.bl, dfpair=True)
        del prod
        y = (dfadj.netsum if fused else dfadj.netsum_plain)(
            oh.view(N, A.m), ol.view(N, A.m), y)
    return df.DF(y.hi[: A.shape[1]], y.lo[: A.shape[1]])


# -- registry entries (SpmvPlan dispatches through these); each forward
# product has its adjoint through the same plan as its transpose ------------
from lilac_tpu_torch.kernels.registry import register_kernel  # noqa: E402

register_kernel("routed", routed_spmv, RoutedMat, transpose=routed_spmv_adj_t)
register_kernel("routed_df", routed_spmv_df, RoutedMat, dfloat=True,
                transpose=routed_spmv_adj_t_df)
register_kernel("routed_hier", routed_hier_spmv, RoutedMatHierP,
                transpose=routed_hier_spmv_adj_t)
register_kernel("routed_hier_df", routed_hier_spmv_df, RoutedMatHierP, dfloat=True,
                transpose=routed_hier_spmv_adj_t_df)
