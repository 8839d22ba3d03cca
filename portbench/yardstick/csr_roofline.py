"""The least bytes of a product with a general sparse matrix in CSR, for
the per-layer rooflines of the configurations that run one.

Counted from the matrix and the vectors alone, whatever implements the
product: no plan, routing network, padding or relabel of the measured
program is counted, so the yardstick stays put when the implementation
changes.
"""

from __future__ import annotations

from portbench.yardstick.roofline import INDEX_BYTES


def csr_spmv_bytes(n: int, nnz: int, word_bytes: int) -> int:
    """y = A x, A square with n rows and nnz entries: A's entries (a value
    of `word_bytes` and a column index each) and its n + 1 row pointers read
    once, x read once, y written once. y = Aᵀ u reads A's entries once too,
    so it counts the same."""
    return nnz * (word_bytes + INDEX_BYTES) + (n + 1) * INDEX_BYTES + 2 * n * word_bytes
