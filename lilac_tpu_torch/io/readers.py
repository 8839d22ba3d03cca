"""Matrix file I/O, host side: MatrixMarket coordinate files and the
SparseBench CRS text format.

Counterpart of lilac_tpu/io/readers.py (`read_matrix_market`,
`write_matrix_market`, `read_sparsebench_crs`, `write_sparsebench_crs`);
a file written by either package reads to the same arrays in the other.
MatrixMarket follows Parboil's semantics: 1-based input, the
off-diagonal entries of a symmetric (skew-symmetric: negated) file
mirrored (parboil convert_dataset.c:82-112), normalised to 0-based
canonical CSR with duplicates summed. The body is parsed by the port's C
parser (native/); where that fails the reader raises, it does not fall
back to a slower parser. The BFS edge-list reader comes with its
workload.
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


def read_sparsebench_crs(path: str):
    """SparseBench on-disk CRS (1-based) -> 0-based canonical CSR, as
    (indptr, indices, data, shape).

    The whole file splits into one token stream, then slices decode the
    header, the pointers and the (column, value) pairs: no per-line Python
    loop, so the suite's largest size (crsmat170u, n = 4.9M, about 25M
    entries) parses in seconds."""
    with open(path) as f:
        toks = f.read().split()
    n, nnz = int(toks[0]), int(toks[1])
    if len(toks) != 2 + (n + 1) + 2 * nnz:
        raise ValueError(f"{path}: token count {len(toks)} != header promise")
    ptr = np.asarray(toks[2 : 3 + n], dtype=np.int64)
    idx = np.asarray(toks[3 + n :: 2], dtype=np.int64)
    val = np.asarray(toks[4 + n :: 2], dtype=np.float64)
    # rows from ptr; entries may be unsorted within rows -> canonicalise
    counts = np.diff(ptr)
    rows = np.repeat(np.arange(n, dtype=np.int64), counts)
    return coo_to_csr_arrays(rows, idx - 1, val, (n, n)) + ((n, n),)


def write_sparsebench_crs(path: str, indptr, indices, data, shape):
    """Write the SparseBench text format (1-based, big_gen.py layout)."""
    n = shape[0]
    nnz = len(indices)
    with open(path, "w") as f:
        f.write(f"{n:12d}{nnz:12d}\n")
        for p in indptr:
            f.write(f"{int(p) + 1:12d}\n")
        for i, v in zip(indices, data):
            f.write(f"{int(i) + 1:12d} {v:20.17f}\n")
