"""Restarted GMRES (SparseBench semantics).

Counterpart of lilac_tpu/solvers/gmres.py, a re-derivation of
SparseBench/SRC/reference/iter.f:106-280: Arnoldi with modified
Gram-Schmidt, an incremental QR of the Hessenberg matrix maintained in
(U, Q) columns, the cheap residual ESTIMATE est = ||r_cycle|| *
|q[0, it+1]| used for convergence (tested against tol * ||r_0||), solution
reconstruction by U-backsolve + Krylov combination at cycle end, and
explicit true-residual restart.

H / Q / U live in [m+2, m+2] buffers (m = restart), as in the reference.
Its `lax` loops and conds are Python loops and branches over eager torch
ops here; each inner iteration reads one predicate back to the host (the
estimate's test), its only read.
"""

from __future__ import annotations

from typing import Callable

import torch


def gmres_solve(
    matvec: Callable,
    A,
    rhs,
    x0,
    *,
    restart: int = 20,
    maxit: int = 100,
    rtol: float = 1e-6,
    psolve: Callable | None = None,
    dtype=torch.float64,
):
    """Returns (x, its, hist, true_error).

    `its` counts inner iterations across cycles at the estimate-based stop
    (matching the reference's hist indexing), a Python int; hist[k] is the
    residual estimate of inner iteration k (1-based k stored at hist[k-1]),
    in float32.
    """
    m = restart
    n = rhs.shape[0]
    dev = rhs.device
    precond = psolve is not None

    def mdot(u, v):
        return (u * v).sum()

    r0 = rhs - matvec(A, x0)
    err0 = torch.sqrt(mdot(r0, r0))

    ncycles = maxit // m + 1
    hist = torch.zeros(ncycles * m, dtype=torch.float32, device=dev)
    x, r = x0, r0
    its_done, done = 0, False
    true_err = torch.zeros((), dtype=dtype, device=dev)

    for cyc in range(ncycles):
        if done:
            break
        err1 = torch.sqrt(mdot(r, r))
        V = torch.zeros((m + 1, n), dtype=dtype, device=dev)
        V[0] = r / err1
        H = torch.zeros((m + 2, m + 2), dtype=dtype, device=dev)
        Q = torch.zeros((m + 2, m + 2), dtype=dtype, device=dev)
        U = torch.zeros((m + 2, m + 2), dtype=dtype, device=dev)

        for it in range(m):  # 0-based inner index (reference it-1)
            if done:
                break
            v_it = V[it]
            mv = psolve(A, v_it) if precond else v_it
            av = matvec(A, mv)

            # modified Gram-Schmidt against v_0..v_it
            for i in range(it + 1):
                h = mdot(V[i], av)
                H[i, it] = h
                av = av - h * V[i]
            hnorm = torch.sqrt(mdot(av, av))
            H[it + 1, it] = hnorm
            V[it + 1] = av / hnorm

            # incremental QR of H's new column into U, Q
            hcol = H[:, it]
            for i in range(it):
                s = (Q[:, i] * hcol).sum()  # q rows beyond i+1 are zero
                U[i, it] = s
                hcol = hcol - s * Q[:, i]
            unorm = torch.sqrt((hcol * hcol).sum())
            U[it, it] = unorm
            Q[:, it] = hcol / unorm

            # orthonormal last column trick (iter.f:206-224): e1
            # orthogonalised against q_0..q_it; only component 0 is used
            q1 = torch.zeros(m + 2, dtype=dtype, device=dev)
            q1[0] = 1.0
            for i in range(it + 1):
                s = (Q[:, i] * q1).sum()
                q1 = q1 - s * Q[:, i]
            qnorm = torch.sqrt((q1 * q1).sum())
            q1_0 = q1[0] / qnorm

            est = err1 * torch.abs(q1_0)
            k = cyc * m + it  # global inner count (0-based)
            hist[k] = est.to(torch.float32)

            conv = bool(est < rtol * err0)  # the one read-back of the iteration
            last = it == m - 1 or k == maxit - 1
            if conv or last:
                # coefficients: usolve on tmp1[i] = q[0, i] * err1, the
                # first it+1 entries; back substitution U y = b, rows it..0
                b = Q[0, : m + 1] * err1
                b = torch.where(torch.arange(m + 1, device=dev) <= it, b, 0.0)
                y = torch.zeros(m + 1, dtype=dtype, device=dev)
                for row in range(it, -1, -1):
                    s = b[row] - (U[row, : m + 1] * y).sum()
                    y[row] = s / U[row, row]
                comb = torch.einsum("k,kn->n", y, V[: m + 1])
                mvv = psolve(A, comb) if precond else comb
                # The reference pairs `x -= z` with `r -= A z`
                # (iter.f:258-262), consistent only if x ACCUMULATES z, so
                # its returned x is the negated solution (never consumed in
                # the benchmark). The production solver returns the honest
                # x = x0 + corrections, matching the residual it reports.
                x = x + mvv
                r = r - matvec(A, mvv)
                true_err = torch.sqrt(mdot(r, r))
                if conv or k == maxit - 1:
                    its_done = k + 1
                    done = True

    its = its_done if done else -maxit
    return x, its, hist[:maxit], true_err
