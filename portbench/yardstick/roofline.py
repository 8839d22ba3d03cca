"""The least bytes of the operations the per-layer rooflines divide by.

Counted from the operation's own inputs and outputs, whatever implements
it: no plan, routing network, padding or permutation of the measured
program is counted, so the yardstick stays put when the implementation
changes.
"""

from __future__ import annotations

import numpy as np

INDEX_BYTES = 4  # a column index or row pointer of a matrix under 2^31 rows


def factored_spmv_bytes(nzv: np.ndarray, word_bytes: int) -> int:
    """y = V^T (s * (V x)) + d x, V with nzv[i] entries in row i: V's
    entries (a value of `word_bytes` and a column index each) and its row
    pointers read once, s and x read once, y written once. One pass over V
    serves both products (row i adds a_i s_i (a_i . x) to y), so V counts
    once."""
    n = len(nzv)
    nnz = int(np.sum(nzv))
    return (nnz * (word_bytes + INDEX_BYTES) + (n + 1) * INDEX_BYTES
            + 3 * n * word_bytes)
