"""Sparse containers of the port: small dataclasses of torch tensors.

Counterpart of lilac_tpu/formats/sparse.py. All formats use 0-based
indexing; index tensors are int64 (torch's indexing dtype). Values may be
any float dtype, or double-word (df64) pairs stored as a trailing [..., 2]
(hi, lo) float32 axis (see lilac_tpu_torch.ops.dfloat). `shape` is the
logical (unpadded) matrix shape.

SlicedELL and SegELLScan are not carried yet; JagELLT is not carried at
all (its only consumer, the reference's `mixed` factored mode, is not
ported).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class COO:
    """Coordinate format: (row[i], col[i]) -> data[i]."""

    row: torch.Tensor  # [nnz] int64
    col: torch.Tensor  # [nnz] int64
    data: torch.Tensor  # [nnz] float
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return self.row.shape[0]


@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed sparse row.

    `row_ids` is an optional [nnz] row-index expansion of indptr (the
    segment ids of the segment-sum SpMV); None until `with_row_ids()`.
    """

    data: torch.Tensor  # [nnz] float (or [nnz, 2] df64)
    indices: torch.Tensor  # [nnz] int64 column indices
    indptr: torch.Tensor  # [nrows + 1] int64
    shape: Tuple[int, int]
    row_ids: Optional[torch.Tensor] = None

    @property
    def nnz(self) -> int:
        return self.indices.shape[0]

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    def with_row_ids(self) -> "CSR":
        if self.row_ids is not None:
            return self
        counts = np.diff(self.indptr.cpu().numpy())
        rid = np.repeat(np.arange(self.shape[0], dtype=np.int64), counts)
        return dataclasses.replace(
            self, row_ids=torch.as_tensor(rid, device=self.indices.device))


@dataclasses.dataclass(frozen=True)
class ELL:
    """ELLPACK: every row padded to a fixed number of slots K.

    Padding slots carry index 0 and value 0, so a gather-multiply-reduce
    over the K axis is exact without masking. The row count may be padded
    (`row_pad` of the converter); `shape` keeps the logical row count.
    """

    data: torch.Tensor  # [nrows_pad, K] float (or [.., 2] df64)
    indices: torch.Tensor  # [nrows_pad, K] int64
    shape: Tuple[int, int]

    @property
    def nrows_pad(self) -> int:
        return self.indices.shape[0]

    @property
    def slots(self) -> int:
        return self.indices.shape[1]


@dataclasses.dataclass(frozen=True)
class BSR:
    """Block sparse row: CSR over dense (bh, bw) blocks (zero-filled)."""

    data: torch.Tensor  # [nblocks, bh, bw] float
    indices: torch.Tensor  # [nblocks] int64 block-column ids
    indptr: torch.Tensor  # [nblockrows + 1] int64
    shape: Tuple[int, int]
    block_shape: Tuple[int, int]

    @property
    def nblocks(self) -> int:
        return self.indices.shape[0]


@dataclasses.dataclass(frozen=True)
class BucketELL:
    """Degree-bucketed ELL: rows permuted ascending by length and split into
    width-quantile buckets, each stored as a dense [n_b, K_b] ELL, so short
    rows do not pad to the longest. `inv_perm` maps original row ->
    position in the bucket-concatenated output.
    """

    data: tuple  # per-bucket [n_b, K_b] float (or [.., 2] df64)
    indices: tuple  # per-bucket [n_b, K_b] int64
    inv_perm: torch.Tensor  # [nrows] int64
    shape: Tuple[int, int]
    widths: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class SegBucketELL:
    """Degree-bucketed ELL (single column segment in the port).

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
