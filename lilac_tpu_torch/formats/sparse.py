"""Sparse containers of the port: small dataclasses of torch tensors.

Counterpart of lilac_tpu/formats/sparse.py; this slice carries the one
format the factored NPB gather path uses.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class SegBucketELL:
    """Degree-bucketed ELL (single column segment in this slice).

    Rows are sorted by ascending length and cut into buckets, each stored
    as its own [n_b, K] ELL block, so short rows do not pad to the longest.
    One row permutation serves every bucket and the output needs a single
    un-permute; near-uniform matrices keep their row order.

    parts: static tuple of (bucket_row_lo, bucket_row_hi, segment, width)
    aligned with the data/indices tuples (segment is always 0 here).
    """

    data: tuple  # per-part [n_b, K] float (or [.., 2] df)
    indices: tuple  # per-part [n_b, K] int64
    inv_perm: torch.Tensor  # [nrows] int64
    shape: Tuple[int, int]
    parts: tuple
    seg_size: int
    identity_perm: bool = False  # original row order kept (uniform rows)
