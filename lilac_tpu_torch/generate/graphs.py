"""Synthetic scale-free graphs for the graph workloads (host numpy).

Counterpart of lilac_tpu/generate/graphs.py: the same seed gives the same
arrays bit for bit. The reference suite runs BFS and PageRank on
SuiteSparse web, road and social graphs (bfs/run_all:3), which are not in
this repository; this Chung-Lu style model keeps their load-bearing
property, heavy-tailed degrees: endpoint i is drawn with probability
proportional to w_i = (i+1)^(-1/(alpha-1)).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def powerlaw_graph(
    n: int,
    avg_deg: float = 16.0,
    alpha: float = 2.1,
    seed: int = 0,
    symmetric: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Tuple[int, int]]:
    """Random directed scale-free graph as 0-based CSR, values all 1.0.

    Duplicate edges and self-loops are removed; n * avg_deg edges are drawn
    before that. `symmetric` adds every edge's reverse. Returns (indptr,
    indices, data, shape)."""
    rng = np.random.default_rng(seed)
    m = int(n * avg_deg)
    w = (np.arange(1, n + 1, dtype=np.float64)) ** (-1.0 / (alpha - 1.0))
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    # tails and heads both power-law; the heads shuffled so that in- and
    # out-degree tails are independent
    src = np.searchsorted(cdf, rng.random(m)).astype(np.int64)
    dst = np.searchsorted(cdf, rng.random(m)).astype(np.int64)
    perm = rng.permutation(n)
    dst = perm[dst]
    keep = src != dst
    src, dst = src[keep], dst[keep]
    key = _sorted_unique(src * n + dst)
    src, dst = key // n, key % n
    if symmetric:
        key = _sorted_unique(np.concatenate([src, dst]) * n + np.concatenate([dst, src]))
        src, dst = key // n, key % n
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, src + 1, 1)
    np.cumsum(indptr, out=indptr)
    return (
        indptr.astype(np.int32),
        dst.astype(np.int32),
        np.ones(len(dst), dtype=np.float64),
        (n, n),
    )


def _sorted_unique(key: np.ndarray) -> np.ndarray:
    """np.unique(key) of an int64 array, by one sort, as numpy before 2.3
    computes it: numpy 2.3.5's np.unique is many times slower on the tens
    of millions of keys of n = 1e6."""
    key = np.sort(key)
    keep = np.ones(len(key), dtype=bool)
    keep[1:] = key[1:] != key[:-1]
    return key[keep]
