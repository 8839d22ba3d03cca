"""PageRank power iteration (the suite's pagerank workload).

Counterpart of lilac_tpu/workloads/pagerank.py, with the semantics of the
reference's pagerank/main.cpp:101-155: the matrix is column-normalised,
then scaled by the damping factor d = 0.85; each iteration computes
y = (d·M)·x + (1 − d)·mean(x) and tracks the l2 step ||y − x||. 1024
iterations a run, 5 timed runs.

The iterations run as a Python loop over torch ops on the plan's device
and read nothing back: the host reads the step norm once, at the end of a
run (which also waits for the card), and x once, after the last run. The
product goes through SpmvPlan, so a routed plan runs the CUDA kernels (K1
on one table; K3-K6 on a hierarchical plan beyond 2^18 columns).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from lilac_tpu_torch.plan import SpmvPlan


def normalise_columns(indptr, indices, data, shape):
    """Column-stochastic normalisation (mm::normalise in the reference):
    each entry divided by its column's sum; empty columns left untouched."""
    colsum = np.zeros(shape[1], dtype=np.float64)
    np.add.at(colsum, indices, data)
    scale = np.where(colsum != 0.0, 1.0 / np.where(colsum == 0, 1.0, colsum), 1.0)
    return data * scale[indices]


@dataclasses.dataclass
class PageRankResult:
    x: np.ndarray
    error: float
    iters: int
    times_s: list
    nnz: int
    build_s: float = 0.0  # the plan's staging (0 for a pre-staged plan)
    plan: Optional[SpmvPlan] = None


def _iterate(plan: SpmvPlan, A, x: torch.Tensor, n: int, d: float, iters: int):
    """`iters` iterations from x in the reference's order; returns (x, the
    last step norm) as device tensors, nothing read back."""
    err = torch.zeros((), dtype=x.dtype, device=x.device)
    for _ in range(iters):
        mean = torch.sum(x) / n
        y = plan.matvec_with(A, x) + (1.0 - d) * mean
        err = torch.sqrt(torch.sum((y - x) ** 2))
        x = y
    return x, err


def run(
    indptr: np.ndarray,
    indices: np.ndarray,
    data: np.ndarray,
    shape,
    *,
    d: float = 0.85,
    iters: int = 1024,
    runs: int = 5,
    dtype: str = "f32",
    seed: int = 0,
    x0: Optional[np.ndarray] = None,
    kernel: str = "auto",
    plan: Optional[SpmvPlan] = None,
    relabel: Optional[bool] = None,
    device="cuda",
) -> PageRankResult:
    """plan: an optional pre-staged SpmvPlan of the values already
    column-normalised and scaled by d, so that a caller can time the
    staging on its own.

    relabel (default: on for routed kernels without a pre-staged plan):
    iterate on A' = P A Pᵀ with rows sorted by length, so that a routed
    plan needs no un-permute network (formats.convert.length_relabel_csr).
    The iteration commutes with P, so the fixed point and the step norms
    are those of A; x is mapped back on return.

    One untimed run comes first, then `runs` timed runs from the same x0."""
    n = shape[0]
    if relabel and plan is not None:
        raise ValueError(
            "relabel=True cannot apply to a pre-staged plan: stage the plan "
            "from length_relabel_csr arrays instead"
        )
    if relabel is None:
        relabel = kernel.startswith("routed") and plan is None
    order = None
    build_s = 0.0
    if plan is None:
        t0 = time.perf_counter()
        scaled = normalise_columns(indptr, indices, data, shape) * d
        if relabel:
            from lilac_tpu_torch.formats.convert import length_relabel_csr

            indptr, indices, scaled, order, _rank = length_relabel_csr(
                indptr, indices, scaled, shape
            )
        plan = SpmvPlan(
            indptr, indices, scaled, shape, dtype=dtype, kernel=kernel,
            reuse="many", device=device,
        )
        build_s = time.perf_counter() - t0

    if x0 is None:
        rng = np.random.default_rng(seed)
        x0 = rng.random(n)
        x0 /= x0.sum()
    if order is not None:
        x0 = np.asarray(x0)[order]

    xd = plan.vec_in(x0)
    xf, err = _iterate(plan, plan.A, xd, n, d, iters)
    float(err)  # the untimed run ends on the card before the first timed one

    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        xf, err = _iterate(plan, plan.A, xd, n, d, iters)
        err_v = float(err)  # the read waits for the card
        times.append(time.perf_counter() - t0)

    x_out = plan.vec_out(xf)
    if order is not None:
        x_nat = np.empty_like(x_out)
        x_nat[order] = x_out
        x_out = x_nat
    return PageRankResult(
        x=x_out, error=err_v, iters=iters, times_s=times, nnz=plan.nnz,
        build_s=build_s, plan=plan,
    )
