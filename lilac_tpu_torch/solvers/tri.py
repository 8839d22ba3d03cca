"""Level-scheduled sparse triangular sweeps.

Counterpart of lilac_tpu/solvers/tri.py. The reference's ILU-D
preconditioner applications are sequential row recurrences
(SparseBench/SRC/reference/random.f:148-190, regular_symm.f:121-311).
Rows are grouped on the host by dependency depth in the triangular pattern
(the schedule arrays are the JAX package's bit for bit); each level is then
one gather, multiply, row-sum and indexed write on the device. The JAX
package runs the levels as one `lax.scan` (an XLA loop, no Pallas kernel);
here they are a Python loop over the levels of eager torch ops, which reads
nothing back to the host.

Arithmetic per row is the same set of multiply-adds as the reference
recurrence (the order inside a row's sum may differ: f64 reduction order
only).

Two sweep flavours cover every SparseBench preconditioner:
  forward : t = (D+P)^-1 x      via t_r = dinv_r * (x_r - Σ_c P_rc t_c)
  backward: y = (I+D^-1 P)^-1 t via y_r = t_r - dinv_r * Σ_c P_rc y_c
with P strictly triangular in the sweep's dependency order. M = (D+L)(I+
D^-1 U) then applies as backward(forward(x)): the reference's ILU-D (and,
with plane-restricted parts, its block-Jacobi).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class LevelSweep:
    """Host-built schedule, ELL-packed per level with uniform padding.

    rows: int64 [nlev, R]   (pad = n, a scratch slot)
    cols: int64 [nlev, R, K] (pad = n)
    vals: f64   [nlev, R, K] (pad = 0)
    Level-0 rows (no stored entries) are handled in the sweep base step.
    """

    n: int
    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor

    @staticmethod
    def build(indptr, indices, data, n: int, device="cuda") -> "LevelSweep":
        rows, cols, vals = level_sweep_arrays(indptr, indices, data, n)
        dev = torch.device(device)
        return LevelSweep(
            n=n,
            rows=torch.as_tensor(rows, device=dev),
            cols=torch.as_tensor(cols, device=dev),
            vals=torch.as_tensor(vals, device=dev),
        )


def level_sweep_arrays(indptr, indices, data, n: int):
    """(rows, cols, vals) of the level schedule as host arrays (int64, int64,
    f64): the JAX package's LevelSweep.build arrays, bit for bit."""
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    data = np.asarray(data, dtype=np.float64)
    counts = np.diff(indptr)
    level = _longest_path_levels(indptr, indices, n)
    nlev = int(level.max()) if n else 0

    if nlev == 0:
        rows = np.full((0, 1), n, dtype=np.int64)
        cols = np.full((0, 1, 1), n, dtype=np.int64)
        vals = np.zeros((0, 1, 1), dtype=np.float64)
    else:
        order = np.argsort(level, kind="stable")
        order = order[level[order] >= 1]
        lv_sizes = np.bincount(level[level >= 1] - 1, minlength=nlev)
        R = int(lv_sizes.max())
        K = int(counts.max()) if len(counts) else 1
        rows = np.full((nlev, R), n, dtype=np.int64)
        cols = np.full((nlev, R, K), n, dtype=np.int64)
        vals = np.zeros((nlev, R, K), dtype=np.float64)
        pos = np.zeros(nlev, dtype=np.int64)
        for r in order:
            k = level[r] - 1
            i = pos[k]
            pos[k] = i + 1
            lo, hi = indptr[r], indptr[r + 1]
            rows[k, i] = r
            cols[k, i, : hi - lo] = indices[lo:hi]
            vals[k, i, : hi - lo] = data[lo:hi]
    return rows, cols, vals


def _longest_path_levels(indptr, indices, n):
    """level[r] = longest dependency chain ending at r (0 for no deps).

    Kahn-style frontier propagation over the reverse adjacency: O(nnz),
    vectorized per frontier. Raises on cyclic (non-triangular) patterns.
    """
    counts = np.diff(indptr).astype(np.int64)
    dep_rows = np.repeat(np.arange(n, dtype=np.int64), counts)
    order = np.argsort(indices, kind="stable")
    rev_targets = dep_rows[order]
    rev_ptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(rev_ptr, indices + 1, 1)
    np.cumsum(rev_ptr, out=rev_ptr)

    level = np.zeros(n, dtype=np.int64)
    pending = counts.copy()
    frontier = np.nonzero(pending == 0)[0]
    resolved = len(frontier)
    while frontier.size:
        # all rows referencing a frontier column
        segs = [rev_targets[rev_ptr[c] : rev_ptr[c + 1]] for c in frontier]
        touched = np.concatenate(segs) if segs else np.empty(0, np.int64)
        if touched.size == 0:
            break
        src_lv = np.concatenate(
            [
                np.full(rev_ptr[c + 1] - rev_ptr[c], level[c] + 1)
                for c in frontier
            ]
        )
        np.maximum.at(level, touched, src_lv)
        np.subtract.at(pending, touched, 1)
        newly = np.unique(touched[pending[touched] == 0])
        frontier = newly
        resolved += len(newly)
    if resolved != n:
        raise ValueError("cyclic pattern: not triangular in any order")
    return level


def _level_loop(sweep: LevelSweep, dinv, x, base, update):
    """Run the levels in order over a padded scratch slot n: one gather,
    multiply, row-sum and indexed write a level (the reference's scan
    step)."""
    n = sweep.n
    t = torch.cat([base, base.new_zeros(1)])
    xp = torch.cat([x, x.new_zeros(1)])
    dp = torch.cat([dinv, dinv.new_ones(1)])
    for k in range(sweep.rows.shape[0]):
        rows, cols, vals = sweep.rows[k], sweep.cols[k], sweep.vals[k]
        contrib = (vals * t[cols]).sum(dim=1)
        # pad rows all write the scratch slot n, which stays 0
        t[rows] = update(xp[rows], dp[rows], contrib)
    return t[:n]


def sweep_forward(sweep: LevelSweep, dinv: torch.Tensor, x: torch.Tensor):
    """t = (D+P)^-1 x."""
    return _level_loop(sweep, dinv, x, dinv * x, lambda xr, dr, c: dr * (xr - c))


def sweep_backward(sweep: LevelSweep, dinv: torch.Tensor, t: torch.Tensor):
    """y = (I + D^-1 P)^-1 t."""
    return _level_loop(sweep, dinv, t, t, lambda tr, dr, c: tr - dr * c)


def make_ilu_d(dinv, L: LevelSweep, U: LevelSweep):
    """M^-1 application for SparseBench's ILU-D: M = (D+L) D^-1 (D+U)
    (random.f:148-190; block-Jacobi is the same with plane-restricted
    parts, regular.f:568-633)."""

    def psolve(x):
        t = sweep_forward(L, dinv, x)
        return sweep_backward(U, dinv, t)

    return psolve
