"""Plain reference for SparseBench's timed BiCG: a frozen copy of the
benchmark matrix's generator, the relabel by row length, and BiCG in IEEE
double as SparseBench writes it, in numpy and plain torch.

Imports nothing of the measured program.

* ``random_crs``: big_gen.py:59-83's random CRS matrix as lilac draws it
  (n = size³ rows, N(5, 4) entries a row clipped to at least 1, the
  diagonal always present, values |N(0, 2)|), frozen here so that a change
  to the program's generator reads wrong instead of moving the yardstick.
* ``relabel``: σ, the rows by descending length, ties in index order. The
  measured program's routed operator numbers its vectors so (position k
  holds row σ[k]), and a driver hands vectors to it in that numbering.
* ``bicg``: iter.f:18-104 without a preconditioner: r = A x − b, rl = r,
  the test ||r|| < rtol·||r0|| at the top of the loop, p = r + β p,
  α = rr / (pl, A p), and the TRUE transpose Aᵀ pl (SparseBench's own
  driver substitutes A, random.f:72). `its` is negative when the test
  never held, as SparseBench reports it.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch


def random_crs(size: int, seed: int = 0, mean_nnz: float = 5.0, std_nnz: float = 4.0):
    """(indptr int64, indices int32, data float64, (n, n)), 0-based CSR with
    columns sorted in each row, n = size³."""
    n = size**3
    rng = np.random.default_rng(seed)
    counts = rng.normal(mean_nnz, std_nnz, size=n).astype(np.int64)
    np.clip(counts, 1, n, out=counts)
    # candidates over-sampled per row, sorted, repeats dropped, the first
    # `counts + 1` kept (the diagonal, candidate 0, always)
    width = int(counts.max()) + 4
    cand = rng.integers(0, n, size=(n, width))
    cand[:, 0] = np.arange(n)
    cand_sorted = np.sort(cand, axis=1)
    fresh = np.ones((n, width), dtype=bool)
    fresh[:, 1:] = cand_sorted[:, 1:] != cand_sorted[:, :-1]
    rank = np.cumsum(fresh, axis=1) - 1
    want = np.minimum(counts + 1, fresh.sum(axis=1))
    keep = fresh & (rank < want[:, None])
    keep |= fresh & (cand_sorted == np.arange(n)[:, None])
    rows = np.broadcast_to(np.arange(n)[:, None], (n, width))[keep]
    cols = cand_sorted[keep]
    vals = np.abs(rng.normal(0.0, 2.0, size=len(cols)))
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    np.cumsum(indptr, out=indptr)
    return indptr, cols.astype(np.int32), vals, (n, n)


def relabel(indptr: np.ndarray) -> np.ndarray:
    """σ: the rows by descending length, ties in index order."""
    return np.argsort(-np.diff(indptr), kind="stable")


def transpose_csr(indptr, indices, data, n: int):
    """The CSR of Aᵀ (columns sorted in each row)."""
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    order = np.argsort(indices, kind="stable")
    t_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(indices, minlength=n), out=t_ptr[1:])
    return t_ptr, rows[order], data[order]


def _csr(indptr, indices, data, n: int, device, dtype) -> torch.Tensor:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # "beta state"
        return torch.sparse_csr_tensor(
            torch.as_tensor(indptr, device=device),
            torch.as_tensor(np.asarray(indices, dtype=np.int64), device=device),
            torch.as_tensor(data, device=device).to(dtype), (n, n),
            check_invariants=False)


class Operator:
    """A and Aᵀ as torch CSR matrices on `device`, in float64."""

    def __init__(self, csr, device, dtype=torch.float64):
        indptr, indices, data, (n, _) = csr
        self.A = _csr(indptr, indices, data, n, device, dtype)
        self.AT = _csr(*transpose_csr(indptr, indices, data, n), n, device, dtype)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return torch.mv(self.A, x)

    def matvec_t(self, x: torch.Tensor) -> torch.Tensor:
        return torch.mv(self.AT, x)


def bicg(op: Operator, b: torch.Tensor, maxit: int = 100, rtol: float = 1e-6):
    """BiCG from x0 = 0 (iter.f:18-104). Returns (x, its, hist): hist the
    residual norms at the top of each iteration run (numpy float64)."""
    x = torch.zeros_like(b)
    r = op.matvec(x) - b
    rl = r.clone()
    p = pl = rr = rn0 = None
    norms = []
    its = -maxit
    for it in range(maxit):
        rn = torch.sqrt(torch.dot(r, r))
        norms.append(rn)
        if it == 0:
            rn0 = rn
        if bool(rn < rtol * rn0):
            its = it + 1
            break
        rr_new = torch.dot(r, rl)
        if it == 0:
            p, pl = r.clone(), rl.clone()
        else:
            beta = rr_new / rr
            p = beta * p + r
            pl = beta * pl + rl
        ap = op.matvec(p)
        apl = op.matvec_t(pl)
        alpha = rr_new / torch.dot(pl, ap)
        x = x - alpha * p
        r = r - alpha * ap
        rl = rl - alpha * apl
        rr = rr_new
    return x, its, torch.stack(norms).cpu().numpy()


def residual_norm(op: Operator, b: torch.Tensor, x: torch.Tensor) -> float:
    """||b − A x|| in float64: SparseBench's true residual
    (Scripts/validate.pl:20-26 holds the recurrence norm to it)."""
    d = b - op.matvec(x)
    return float(torch.sqrt(torch.dot(d, d)))
