"""Random CRS matrix generator (SparseBench big_gen semantics).

Mirrors SparseBench/big_gen.py:59-83: per-row nonzero counts
drawn from N(5, 4) clipped to [1, n], columns sampled without replacement
with the diagonal forced present, values |N(0, 2)|. Deterministic under a
seed. Returns 0-based canonical CSR in float64.

Vectorized (no per-row Python loop) so the reference's largest benchmark
size — crsmat170u, n = 170³ ≈ 4.9M rows (BASELINE.json, SparseBench
README:76) — builds in seconds: candidate columns are over-sampled per row,
deduplicated with a sort over (row, col), and trimmed back to the requested
count. The DISTRIBUTION matches big_gen; the exact RNG stream is not golden
data (the benchmark protocol times the solver, not the matrix).

Counterpart of lilac_tpu/generate/random_crs.py: the same seed gives the
same arrays bit for bit."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def random_crs(
    size: int, seed: int = 0, mean_nnz: float = 5.0, std_nnz: float = 4.0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Tuple[int, int]]:
    n = size**3
    rng = np.random.default_rng(seed)
    counts = rng.normal(mean_nnz, std_nnz, size=n).astype(np.int64)
    np.clip(counts, 1, n, out=counts)

    # over-sample candidates (counts + slack), dedup per row, trim to count
    slack = 4
    width = int(counts.max()) + slack
    cand = rng.integers(0, n, size=(n, width))
    cand[:, 0] = np.arange(n)  # force the diagonal
    cand_sorted = np.sort(cand, axis=1)
    fresh = np.ones((n, width), dtype=bool)
    fresh[:, 1:] = cand_sorted[:, 1:] != cand_sorted[:, :-1]
    # rank of each fresh candidate within its row
    rank = np.cumsum(fresh, axis=1) - 1
    want = np.minimum(counts + 1, fresh.sum(axis=1))  # +1 for the diagonal
    keep = fresh & (rank < want[:, None])
    # diagonal must survive trimming: it's guaranteed fresh; if it ranked
    # past `want`, swap it in by keeping it explicitly
    is_diag = cand_sorted == np.arange(n)[:, None]
    keep |= is_diag & fresh

    rows = np.broadcast_to(np.arange(n)[:, None], (n, width))[keep]
    cols = cand_sorted[keep]
    vals = np.abs(rng.normal(0.0, 2.0, size=len(cols)))

    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    np.cumsum(indptr, out=indptr)
    return indptr.astype(np.int64), cols.astype(np.int32), vals, (n, n)
