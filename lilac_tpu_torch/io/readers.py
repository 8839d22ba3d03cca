"""Matrix file I/O, host side: MatrixMarket coordinate files.

Counterpart of lilac_tpu/io/readers.py (`read_matrix_market`,
`write_matrix_market`). Parboil's semantics: 1-based input, the
off-diagonal entries of a symmetric (skew-symmetric: negated) file
mirrored (parboil convert_dataset.c:82-112), normalised to 0-based
canonical CSR with duplicates summed. The body is parsed by the port's C
parser (native/); where that fails the reader raises, it does not fall
back to a slower parser. The SparseBench CRS and BFS edge-list readers
come with their workloads.
"""

from __future__ import annotations

import numpy as np

from lilac_tpu_torch.formats.convert import coo_to_csr_arrays


def read_matrix_market(path: str):
    """Returns (indptr, indices, data, shape), 0-based canonical CSR."""
    from lilac_tpu_torch import native

    with open(path) as f:
        header = f.readline()
        if not header.startswith("%%MatrixMarket"):
            raise ValueError(f"{path}: not a MatrixMarket file")
        parts = header.lower().split()
        fmt, field, symm = parts[2], parts[3], parts[4]
        if fmt != "coordinate":
            raise NotImplementedError("only coordinate MatrixMarket supported")
        skip = 1
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
            skip += 1
        rows, cols, nnz = map(int, line.split())
        skip += 1
    r, c, v = native.mm_parse_body(path, skip, nnz, field == "pattern")
    r = r - 1
    c = c - 1
    if symm in ("symmetric", "skew-symmetric", "hermitian"):
        off = r != c
        sgn = -1.0 if symm == "skew-symmetric" else 1.0
        r, c, v = (
            np.concatenate([r, c[off]]),
            np.concatenate([c, r[off]]),
            np.concatenate([v, sgn * v[off]]),
        )
    indptr, indices, vals = coo_to_csr_arrays(r, c, v, (rows, cols))
    return indptr, indices, vals, (rows, cols)


def write_matrix_market(path: str, indptr, indices, data, shape,
                        pattern: bool = False):
    """Write a coordinate MatrixMarket file (1-based, general symmetry).
    Formatting runs in chunks of 2^20 entries to bound host memory."""
    n, m = shape
    nnz = len(indices)
    counts = np.diff(indptr)
    rows = np.repeat(np.arange(n, dtype=np.int64), counts) + 1
    cols = np.asarray(indices, dtype=np.int64) + 1
    with open(path, "w") as f:
        field = "pattern" if pattern else "real"
        f.write(f"%%MatrixMarket matrix coordinate {field} general\n")
        f.write(f"{n} {m} {nnz}\n")
        step = 1 << 20
        for i0 in range(0, nnz, step):
            r = rows[i0 : i0 + step]
            c = cols[i0 : i0 + step]
            if pattern:
                chunk = "\n".join(f"{a} {b}" for a, b in zip(r, c))
            else:
                v = np.asarray(data[i0 : i0 + step], dtype=np.float64)
                chunk = "\n".join(f"{a} {b} {x:.17g}" for a, b, x in zip(r, c, v))
            f.write(chunk)
            f.write("\n")
