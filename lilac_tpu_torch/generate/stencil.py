"""Regular 7-point 3D stencil matrix (SparseBench 'regular' structure).

The reference stores the stencil as a dense diagonal-band array and applies
it with nested loops (SparseBench/SRC/reference/regular.f:13-77).
Here we materialise the same operator as canonical CSR so every SpMV backend
can run it; a purely stencil-structured (matrix-free) path is a natural
later optimisation (it is a convolution).

The classic test operator is the 3D Laplacian: 6 on the diagonal, -1 on the
six off-diagonals, on an n1 x n2 x n3 grid with Dirichlet truncation.
Counterpart of lilac_tpu/generate/stencil.py, the same arrays bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from lilac_tpu_torch.formats.convert import coo_to_csr_arrays


def seven_point_csr(
    n1: int,
    n2: int,
    n3: int | None = None,
    diag: float = 6.0,
    off: float = -1.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Tuple[int, int]]:
    if n3 is None:
        n3 = n2
    n = n1 * n2 * n3
    idx = np.arange(n, dtype=np.int64)
    i1 = idx % n1
    i2 = (idx // n1) % n2
    i3 = idx // (n1 * n2)

    rows, cols, vals = [idx], [idx], [np.full(n, diag)]
    for delta, guard in [
        (-1, i1 > 0),
        (+1, i1 < n1 - 1),
        (-n1, i2 > 0),
        (+n1, i2 < n2 - 1),
        (-n1 * n2, i3 > 0),
        (+n1 * n2, i3 < n3 - 1),
    ]:
        sel = np.nonzero(guard)[0]
        rows.append(sel)
        cols.append(sel + delta)
        vals.append(np.full(len(sel), off))
    row = np.concatenate(rows)
    col = np.concatenate(cols)
    val = np.concatenate(vals)

    indptr, indices, data = coo_to_csr_arrays(row, col, val, (n, n))
    return indptr, indices, data, (n, n)
