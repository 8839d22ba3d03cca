"""Breadth-first search as a masked SpMV (the suite's bfs workload).

Counterpart of lilac_tpu/workloads/bfs.py, with the semantics of the
reference's bfs/bfs.cc:36-68 (Yang / Buluç style): the frontier advances
as `front = (M·front ≠ 0) & unvisited`, and `distances` doubles as the
visited set: the source holds 1, a node first reached at sweep i holds
i + 1, an unreachable node 0. The reference's 2-based column quirk
(library.cc:74, SURVEY.md section 3.5) is not reproduced: the indexing is
the cited algorithm's, 0-based.

A level is a product through SpmvPlan (a routed plan runs the CUDA
kernels) and two torch selects over dense {0, 1} f32 vectors on the
plan's device. The host reads one boolean a level, any(front), to decide
whether to go on, and the distances once at the end. 16 random sources a
benchmark run (bfs.cc:85-90).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from lilac_tpu_torch.plan import SpmvPlan


def bfs_distances(plan: SpmvPlan, source: int) -> np.ndarray:
    """Distances by the reference's convention: source 1, its neighbours
    2, ..., unreachable 0 (f32). The reference's per-plan runner cache
    holds a compiled program; here there is nothing to compile."""
    front = torch.zeros(plan.shape[0], dtype=torch.float32, device=plan.device)
    front[source] = 1.0
    dist = front.clone()
    i = 1.0
    while True:
        nxt = plan.matvec_with(plan.A, front)
        front = ((nxt != 0.0) & (dist == 0.0)).to(torch.float32)
        dist = torch.where(front != 0.0, i + 1.0, dist)
        i += 1.0
        if not bool(front.any()):  # the one read of a level
            break
    return dist.cpu().numpy()


@dataclasses.dataclass
class BFSResult:
    time_s: float
    runs: int
    n: int
    nnz: int
    build_s: float = 0.0  # the plan's staging, the relabel included
    plan: Optional[SpmvPlan] = None
    sources: Optional[np.ndarray] = None  # [runs], the graph's own numbering
    distances: Optional[np.ndarray] = None  # [runs, n] f32, the graph's numbering


def run_benchmark(
    indptr, indices, data, shape, *, runs: int = 16, seed: int = 0,
    kernel: str = "auto", relabel: bool | None = None, device="cuda",
) -> BFSResult:
    """`runs` random-source BFS runs, timed on the wall clock after one
    untimed run from the first source (bfs.cc:80-95).

    relabel (default: on for routed kernels): BFS levels are invariant
    under a relabeling of the nodes, so the run on A' = P A Pᵀ with rows
    sorted by length (sources mapped through P) does the same work, and a
    routed plan needs no un-permute network. The distances are mapped back
    after the timed loop."""
    if relabel is None:
        relabel = kernel.startswith("routed")
    data = np.ones_like(data)  # BFS reads the pattern only
    t0 = time.perf_counter()
    order = rank = None
    if relabel:
        from lilac_tpu_torch.formats.convert import length_relabel_csr

        indptr, indices, data, order, rank = length_relabel_csr(
            indptr, indices, data, shape
        )
    plan = SpmvPlan(
        indptr, indices, data, shape, dtype="f32", kernel=kernel,
        reuse="many", device=device,
    )
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    sources = rng.integers(0, shape[0], size=runs)
    plan_sources = sources if rank is None else rank[sources]
    bfs_distances(plan, int(plan_sources[0]))  # untimed first run
    t0 = time.perf_counter()
    dists = [bfs_distances(plan, int(s)) for s in plan_sources]
    time_s = time.perf_counter() - t0
    dists = np.stack(dists)
    if order is not None:
        nat = np.empty_like(dists)
        nat[:, order] = dists
        dists = nat
    return BFSResult(
        time_s=time_s, runs=runs, n=shape[0], nnz=plan.nnz, build_s=build_s,
        plan=plan, sources=sources, distances=dists,
    )


def bfs_oracle(indptr, indices, data, shape, source) -> np.ndarray:
    """Host oracle of the masked-SpMV semantics (front = (M·front != 0) &
    unvisited) with scipy, f64."""
    import scipy.sparse as sp

    M = sp.csr_matrix((np.ones_like(data), indices, indptr), shape=shape)
    n = shape[0]
    dist = np.zeros(n)
    dist[source] = 1.0
    front = np.zeros(n)
    front[source] = 1.0
    level = 1.0
    while True:
        nxt = M @ front
        front = ((nxt != 0.0) & (dist == 0.0)).astype(np.float64)
        if not front.any():
            return dist
        level += 1.0
        dist[front != 0.0] = level
