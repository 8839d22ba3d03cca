"""Native (C) host runtime of the port: the NPB makea random stream, the
SparseBench gen_crs fill loop, the Benes cycle-walk colouring and the
MatrixMarket body parser, compiled with
the system C compiler at first use and loaded through ctypes.

Counterpart of lilac_tpu/native/__init__.py, with its own copy of the C
source (src/lilac_native.c). The library is built on the first call, not
when the module is imported, into native/build/ (git-ignored). The NPB
and SparseBench generators and the network construction guard with
``available()`` and use their pure-numpy constructors when no C compiler is
at hand; the MatrixMarket
reader has no second parser, so a failure there raises.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "src", "lilac_native.c")
_SO = os.path.join(_HERE, "build", "_lilac_native.so")

_lib = None
_failed = False


def _build() -> str:
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return _SO
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    cc = os.environ.get("CC", "cc")
    # per-process temp name: concurrent cold builds must not clobber each
    # other's half-written .so before the atomic publish
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = [cc, "-O2", "-shared", "-fPIC", "-o", tmp, _SRC, "-lm"]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, _SO)
    return _SO


def _load():
    global _lib, _failed
    if _lib is not None:
        return _lib
    if _failed:
        raise OSError("native library build failed earlier in this process")
    try:
        lib = ctypes.CDLL(_build())
    except (OSError, subprocess.CalledProcessError):
        _failed = True
        raise
    lib.npb_triples.restype = ctypes.c_long
    lib.npb_triples.argtypes = [
        ctypes.c_long,
        ctypes.c_int,
        np.ctypeslib.ndpointer(np.int32, flags="C"),
        np.ctypeslib.ndpointer(np.int64, flags="C"),
        np.ctypeslib.ndpointer(np.float64, flags="C"),
    ]
    lib.mm_parse_body.restype = ctypes.c_long
    lib.mm_parse_body.argtypes = [
        ctypes.c_char_p,
        ctypes.c_long,
        ctypes.c_long,
        ctypes.c_int,
        np.ctypeslib.ndpointer(np.int64, flags="C"),
        np.ctypeslib.ndpointer(np.int64, flags="C"),
        np.ctypeslib.ndpointer(np.float64, flags="C"),
    ]
    lib.sb_fill_matrix.restype = ctypes.c_long
    lib.sb_fill_matrix.argtypes = [
        np.ctypeslib.ndpointer(np.int64, flags="C"),
        ctypes.c_long,
        ctypes.c_long,
        ctypes.c_int,
        ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_long,
        np.ctypeslib.ndpointer(np.int64, flags="C"),
        np.ctypeslib.ndpointer(np.int64, flags="C"),
        np.ctypeslib.ndpointer(np.float64, flags="C"),
        np.ctypeslib.ndpointer(np.float64, flags="C"),
    ]
    lib.benes_route_c.restype = ctypes.c_int
    lib.benes_route_c.argtypes = [
        ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int32, flags="C"),
        np.ctypeslib.ndpointer(np.uint8, flags="C"),
    ]
    _lib = lib
    return lib


def available() -> bool:
    """True when the C library is (or can be) built and loaded."""
    try:
        _load()
    except (OSError, subprocess.CalledProcessError):
        return False
    return True


def npb_triples(na: int, nonzer: int):
    """C fast path for makea phase 1 (exact randlc stream)."""
    lib = _load()
    nzv = np.empty(na, dtype=np.int32)
    pos = np.empty(na * (nonzer + 1), dtype=np.int64)
    val = np.empty(na * (nonzer + 1), dtype=np.float64)
    w = lib.npb_triples(na, nonzer, nzv, pos, val)
    return nzv, pos[:w], val[:w]


def sb_fill_matrix(splits: np.ndarray, n: int, sym: bool, state: int):
    """C fast path for SparseBench gen_crs fill (exact DLARAN stream).

    Returns (rows, cols, vals, diag, new_state); rows/cols 1-based like the
    Python loop, diagonal values returned separately (entries 1..n first).
    The C loop never writes past its buffers: on overflow it returns -1
    and the call retries with four times the room."""
    lib = _load()
    splits = np.ascontiguousarray(splits, dtype=np.int64)
    cap = 40 * n + 16 * len(splits)  # generous: the reference caps at 15n total
    for _ in range(4):
        rows = np.empty(cap, dtype=np.int64)
        cols = np.empty(cap, dtype=np.int64)
        vals = np.empty(cap, dtype=np.float64)
        diag = np.zeros(n, dtype=np.float64)
        out_state = ctypes.c_uint64(0)
        top = lib.sb_fill_matrix(
            splits, len(splits), n, int(sym), state, ctypes.byref(out_state),
            cap, rows, cols, vals, diag,
        )
        if top >= 0:
            return rows[:top], cols[:top], vals[:top], diag, int(out_state.value)
        last_cap = cap
        cap *= 4
    raise MemoryError(f"sb_fill_matrix overflow: n={n} needs > {last_cap} entries")


def mm_parse_body(path: str, skip_lines: int, nnz: int, pattern: bool):
    """(rows, cols, vals) of a MatrixMarket coordinate body, 1-based as in
    the file: skip_lines header lines, then nnz entries (pattern: unit
    values). Raises when the file has fewer entries than promised."""
    lib = _load()
    rows = np.empty(nnz, dtype=np.int64)
    cols = np.empty(nnz, dtype=np.int64)
    vals = np.empty(nnz, dtype=np.float64)
    k = lib.mm_parse_body(os.fsencode(path), skip_lines, nnz, int(pattern),
                          rows, cols, vals)
    if k != nnz:
        raise ValueError(f"{path}: parsed {k} of {nnz} entries")
    return rows, cols, vals


def benes_route(perm: np.ndarray) -> np.ndarray:
    """Switch masks [S, m] uint8 for one permutation (C hot path;
    kernels/routenet.py falls back to the numpy constructor without it)."""
    lib = _load()
    perm = np.ascontiguousarray(perm, dtype=np.int32)
    m = len(perm)
    S = 2 * int(np.log2(m)) - 1 if m > 2 else 1
    out = np.empty((S, m), dtype=np.uint8)
    rc = lib.benes_route_c(m, perm, out)
    if rc != S:
        raise RuntimeError(f"benes_route_c failed: {rc}")
    return out
