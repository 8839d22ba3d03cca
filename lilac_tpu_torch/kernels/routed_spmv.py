"""SpMV through plan-time routing networks (single table).

Counterpart of the single-table part of lilac_tpu/kernels/routed_spmv.py.
Pipeline per matvec: pad x into the network input slots ([m] = [R, 128]
planes), run every row-chunk's gather network in one routed_apply call
(kernels/routed.py), then multiply by the values, pre-arranged at PLAN
time into the routed slot order, and reduce each chunk's [rows_c, K_c]
block (df64: the fused kernel of kernels/dfmulred.py).

Rows are chunked after sorting by row length (descending), so each chunk
pads to its own max length; the row order is restored by one [n]-sized
gather at the end. Matrices with near-uniform rows skip the sort.

Single column segment: requires ncols <= m (the network input table holds
all of x). The hierarchical plans for larger tables are not ported yet.

Plan files (`save_routed` / `load_routed`) use the JAX package's npz
format, so a plan written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from lilac_tpu_torch.kernels import dfmulred as dfk
from lilac_tpu_torch.kernels import routed as rd
from lilac_tpu_torch.kernels import routenet as rn
from lilac_tpu_torch.ops import dfloat as df


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
        h, l_ = dfk.chunk_reduce_net_df(
            df.DF(prod.hi[c], prod.lo[c]), ((0, rows_c, k_c),), colmajor
        )
        his.append(h)
        los.append(l_)
    return torch.cat(his), torch.cat(los)


def _mulreduce_df_2d(vals, oh, ol, chunks, colmajor):
    """df64 mul+row-sum for the [B, m] single-table container: chunk c is
    net-row c's leading rows_c*k_c slots. Column-major plans with the
    df_fused knob on take the fused kernel, else the op chain."""
    from lilac_tpu_torch.config import cfg

    if colmajor and cfg().df_fused:
        his, los = [], []
        for c, (rows_c, k_c) in enumerate(chunks):
            h, l_ = dfk.chunk_mulreduce_df(
                vals[c], oh[c], ol[c], ((0, rows_c, k_c),), True, fused=True
            )
            his.append(h)
            los.append(l_)
        return torch.cat(his), torch.cat(los)
    prod = df.mul(df.DF(vals[..., 0], vals[..., 1]), df.DF(oh, ol))
    return _chunk_reduce_df(prod, chunks, colmajor)


def routed_spmv(A: RoutedMat, x: torch.Tensor) -> torch.Tensor:
    (out,) = rd.routed_apply(
        [_pad_plane(x.to(A.vals.dtype), A.m)], A.masks, A.kinds, A.dists
    )
    prod = A.vals * out.view(len(A.chunks), A.m)
    y = _chunk_reduce(prod, A.chunks, A.m, A.colmajor)
    if A.inv_perm is not None:
        y = y[A.inv_perm]
    return y[: A.shape[0]]


def routed_spmv_df(A: RoutedMat, x: df.DF) -> df.DF:
    oh, ol = rd.routed_apply(
        [_pad_plane(x.hi, A.m), _pad_plane(x.lo, A.m)],
        A.masks, A.kinds, A.dists,
    )
    B = len(A.chunks)
    hi, lo = _mulreduce_df_2d(
        A.vals, oh.view(B, A.m), ol.view(B, A.m), A.chunks, A.colmajor
    )
    if A.inv_perm is not None:
        hi, lo = hi[A.inv_perm], lo[A.inv_perm]
    return df.DF(hi[: A.shape[0]], lo[: A.shape[0]])


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


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_routed(path: str, M: RoutedMat) -> None:
    if not isinstance(M, RoutedMat):
        raise TypeError(f"save_routed takes a RoutedMat, got {type(M).__name__}")
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


def load_routed(path: str, device="cuda") -> Optional[RoutedMat]:
    """Load a RoutedMat plan file; None for another cache version. A file
    of another container class (hierarchical, column-segmented) raises
    NotImplementedError: those plans are not ported yet."""
    z = np.load(path, allow_pickle=False)
    if int(z["version"]) != _CACHE_VERSION:
        return None
    if str(z["cls"]) != "RoutedMat":
        raise NotImplementedError(
            f"{path}: plan class {str(z['cls'])} is not ported (hierarchical "
            "plans come with the routed_apply_sliced_b family of kernels)"
        )
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
