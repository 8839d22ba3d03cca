"""Preconditioners: Jacobi, ILU(0) with level scheduling.

Counterpart of lilac_tpu/solvers/precond.py. Reference semantics:
SparseBench preconditioner menu (SparseBench/SRC/reference/iter.f:311-376):
1=Jacobi (pointwise multiply by inverse diagonal), 2=ILU, 3=block-Jacobi,
4=line-ILU (solvers/line_ilu.py; ILU-D and block-Jacobi are the level
sweeps of solvers/tri.py). ILU triangular solves are sequential
(random.f/regular.f ilusolve routines); they run LEVEL SCHEDULED: rows
grouped by dependency depth on the host, each level solved as one
vectorized gather / multiply / scatter step, O(#levels) device steps
instead of O(n).

Factorization and schedules run on the host in numpy (the same arrays as
the JAX package's, bit for bit); the solves are Python loops over the
levels of eager torch ops (the reference's fori_loop), reading nothing back.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Jacobi
# ---------------------------------------------------------------------------


def jacobi_inverse_diagonal(indptr, indices, data, shape) -> np.ndarray:
    """m = 1/diag(A) (SparseBench stores this vector as the Jacobi
    preconditioner and applies it with a pointwise multiply)."""
    n = shape[0]
    diag = np.zeros(n, dtype=np.float64)
    for_rows = np.repeat(np.arange(n), np.diff(indptr))
    mask = for_rows == indices
    diag[for_rows[mask]] = data[mask]
    if np.any(diag == 0.0):
        raise ValueError("zero diagonal; Jacobi preconditioner undefined")
    return 1.0 / diag


# ---------------------------------------------------------------------------
# ILU(0) — host factorization
# ---------------------------------------------------------------------------


def ilu0_factor(indptr, indices, data, shape):
    """In-place ILU(0): L (unit lower) and U share A's sparsity pattern.

    Standard IKJ algorithm restricted to the pattern — the same math the
    reference's crs ILU produces. Returns the combined factor values
    aligned with (indptr, indices) plus the diagonal positions.
    """
    n = shape[0]
    vals = data.astype(np.float64).copy()
    # position lookup per row: dict-free via sorted indices + searchsorted
    diag_pos = np.empty(n, dtype=np.int64)
    for i in range(n):
        row = slice(indptr[i], indptr[i + 1])
        cols = indices[row]
        dp = np.searchsorted(cols, i)
        if dp >= len(cols) or cols[dp] != i:
            raise ValueError(f"missing diagonal in row {i}")
        diag_pos[i] = indptr[i] + dp
    for i in range(1, n):
        r0, r1 = indptr[i], indptr[i + 1]
        cols_i = indices[r0:r1]
        for kk in range(r0, r1):
            k = indices[kk]
            if k >= i:
                break
            piv = vals[diag_pos[k]]
            lik = vals[kk] / piv
            vals[kk] = lik
            # subtract lik * U[k, j] for j in row i's pattern, j > k
            ks, ke = diag_pos[k] + 1, indptr[k + 1]
            if ks >= ke:
                continue
            cols_k = indices[ks:ke]
            pos = np.searchsorted(cols_i, cols_k)
            valid = (pos < len(cols_i)) & (cols_i[np.minimum(pos, len(cols_i) - 1)] == cols_k)
            vals[r0 + pos[valid]] -= lik * vals[ks:ke][valid]
    return vals, diag_pos


def _level_schedule(indptr, indices, n, lower: bool) -> np.ndarray:
    """Dependency depth of each row for the triangular solve."""
    level = np.zeros(n, dtype=np.int64)
    if lower:
        order = range(n)
    else:
        order = range(n - 1, -1, -1)
    for i in order:
        lv = 0
        for k in range(indptr[i], indptr[i + 1]):
            j = indices[k]
            if (lower and j < i) or ((not lower) and j > i):
                lv = max(lv, level[j] + 1)
        level[i] = lv
    return level


@dataclasses.dataclass
class ILU0:
    """ILU(0) apply on the device via level-scheduled sweeps.

    solve(y) computes (LU)^-1 y with one loop over levels; each level
    applies a masked SpMV-style update. Transpose solve supported for BiCG.
    """

    # combined factor in CSR (device)
    data: torch.Tensor
    indices: torch.Tensor
    row_ids: torch.Tensor
    diag: torch.Tensor  # U diagonal values [n]
    lower_level: torch.Tensor  # [n] level of each row in L-solve
    upper_level: torch.Tensor
    lower_level_t: torch.Tensor  # levels for the transpose solves
    upper_level_t: torch.Tensor
    n_lower_levels: int
    n_upper_levels: int
    n_lower_levels_t: int
    n_upper_levels_t: int
    shape: Tuple[int, int]

    @staticmethod
    def build(indptr, indices, data, shape, device="cuda") -> "ILU0":
        vals, diag_pos = ilu0_factor(indptr, indices, data, shape)
        n = shape[0]
        lo = _level_schedule(indptr, indices, n, lower=True)
        up = _level_schedule(indptr, indices, n, lower=False)
        # transpose pattern for the shadow (BiCG) solves
        counts = np.diff(indptr)
        rid = np.repeat(np.arange(n, dtype=np.int64), counts)
        order = np.lexsort((rid, indices))
        t_rows = indices[order].astype(np.int64)
        t_cols = rid[order]
        t_indptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(t_indptr, t_rows + 1, 1)
        np.cumsum(t_indptr, out=t_indptr)
        lo_t = _level_schedule(t_indptr, t_cols, n, lower=False)
        up_t = _level_schedule(t_indptr, t_cols, n, lower=True)
        dev = torch.device(device)

        def idx(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int64), device=dev)

        return ILU0(
            data=torch.as_tensor(vals, device=dev),
            indices=idx(indices),
            row_ids=idx(rid),
            diag=torch.as_tensor(vals[diag_pos], device=dev),
            lower_level=idx(lo),
            upper_level=idx(up),
            lower_level_t=idx(lo_t),
            upper_level_t=idx(up_t),
            n_lower_levels=int(lo.max()) + 1,
            n_upper_levels=int(up.max()) + 1,
            n_lower_levels_t=int(lo_t.max()) + 1,
            n_upper_levels_t=int(up_t.max()) + 1,
            shape=tuple(shape),
        )

    def solve(self, y):
        """x = U^-1 L^-1 y (forward then backward level sweeps)."""
        n = self.shape[0]
        rid, cid, v = self.row_ids, self.indices, self.data
        strict_lower = cid < rid
        strict_upper = cid > rid

        def sweep(x, levels, nlev, mask, diag_scale):
            row_level = levels[rid]
            for lv in range(nlev):
                active = row_level == lv
                contrib = torch.where(mask & active, v * x[cid], 0.0)
                s = torch.zeros(n, dtype=x.dtype, device=x.device).index_add_(
                    0, rid, contrib)
                row_active = levels == lv
                newx = (x - s) if diag_scale is None else (x - s) / self.diag
                x = torch.where(row_active, newx, x)
            return x

        # L-solve: x_i = y_i - sum_{j<i} L_ij x_j (unit diagonal)
        x = sweep(y, self.lower_level, self.n_lower_levels, strict_lower, None)
        # U-solve: x_i = (x_i - sum_{j>i} U_ij x_j) / U_ii
        x = sweep(x, self.upper_level, self.n_upper_levels, strict_upper, 1)
        return x

    def solve_t(self, y):
        """x = L^-T U^-T y for the BiCG shadow solve."""
        n = self.shape[0]
        rid, cid, v = self.row_ids, self.indices, self.data
        strict_upper = cid > rid
        strict_lower = cid < rid

        # U^T solve: rows of U^T = columns of U, in increasing column level
        # order of the transpose dependency graph, as a scatter
        def sweep_t(x, levels_cols, nlev, mask, diag):
            row_level = levels_cols[rid]
            for lv in range(nlev):
                # divide newly-ready entries by diag first (for U^T)
                if diag is not None:
                    x = torch.where(levels_cols == lv, x / self.diag, x)
                active = mask & (row_level == lv)
                contrib = torch.where(active, v * x[rid], 0.0)
                upd = torch.zeros(n, dtype=x.dtype, device=x.device).index_add_(
                    0, cid, contrib)
                x = x - upd
            return x

        x = sweep_t(y, self.upper_level_t, self.n_upper_levels_t, strict_upper, 1)
        x = sweep_t(x, self.lower_level_t, self.n_lower_levels_t, strict_lower, None)
        return x
