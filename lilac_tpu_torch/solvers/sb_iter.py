"""Faithful SparseBench iterative methods (golden-table semantics).

Counterpart of lilac_tpu/solvers/sb_iter.py: the reference solvers with
their exact update order, residual recording and stopping rules, so that
the `reference_results` golden table (iterations exact, residual ±5%) is
reproduced:

* sb_cg    — SparseBench/SRC/reference/iter_symm.f:18-117
             (hist(it) = ||r|| at loop top, r0 = A x0 - b, x -= alpha p)
* sb_gmres — SparseBench/SRC/reference/iter.f:106-290
             (modified Gram-Schmidt, bespoke QR update of the Hessenberg,
             est = err1*|q(1,it+1)| recorded per iteration, restart cycles)

The JAX package unrolls the iterations statically with a `done` mask. Here
they are Python loops over eager torch ops that stop where the mask would
freeze everything: entries of `hist` past the stop stay 0 and `its` has
the reference's sign. Each iteration reads one predicate back to the host
(sb_cg: the convergence test; sb_gmres: the estimate's test), its only
read. The general production solvers live in cg.py / bicg.py / gmres.py;
these exist to pin the port to the reference's verification data.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def _norm(v):
    return torch.sqrt((v * v).sum())


def sb_cg(
    matvec: Callable,
    b: torch.Tensor,
    *,
    maxit: int,
    rtol: float,
    psolve: Optional[Callable] = None,
):
    """Returns (x, hist[maxit], its). hist entries beyond the stopping
    iteration stay 0 (what history_print skips); its < 0 means maxit hit
    without convergence (iter_symm.f:96 sign convention); its is a Python
    int."""
    n = b.shape[0]
    x = torch.zeros(n, dtype=b.dtype, device=b.device)
    r = matvec(x) - b  # iter_symm.f:44-48 (note the sign)
    hist = torch.zeros(maxit, dtype=b.dtype, device=b.device)
    p = torch.zeros_like(x)
    rr_prev = None
    rn0 = None
    its = -maxit

    for it in range(1, maxit + 1):
        rn = _norm(r)
        hist[it - 1] = rn
        if it == 1:
            rn0 = rn
        if bool(rn < rtol * rn0):  # the one read-back of the iteration
            its = it
            break
        z = psolve(r) if psolve is not None else r
        rr = (r * z).sum()
        p = z if it == 1 else z + (rr / rr_prev) * p
        ap = matvec(p)
        alpha = rr / (p * ap).sum()
        x = x - alpha * p
        r = r - alpha * ap
        rr_prev = rr
    return x, hist, its


def sb_gmres(
    matvec: Callable,
    b: torch.Tensor,
    *,
    restart: int,
    maxit: int,
    tol: float,
    psolve: Optional[Callable] = None,
):
    """Returns (x, hist[maxit]). hist holds the per-iteration error estimate
    est = err1*|q(1,it+1)| (iter.f:232-233); entries after the stopping
    iteration stay 0. x0 = 0, rhs = b (main.f:341-345)."""
    n = b.shape[0]
    m = restart
    ncycles = maxit // restart + 1
    dt, dev = b.dtype, b.device
    x = torch.zeros(n, dtype=dt, device=dev)
    r = b - matvec(x)  # iter.f:140-142 (opposite sign from CG)
    err0 = _norm(r)
    hist = torch.zeros(maxit, dtype=dt, device=dev)
    done = False

    for cycle in range(1, ncycles + 1):
        if done:
            break
        err1 = _norm(r)
        V = torch.zeros((m + 1, n), dtype=dt, device=dev)
        V[0] = r / err1
        H = torch.zeros((m + 1, m + 1), dtype=dt, device=dev)
        Q = torch.zeros((m + 1, m + 1), dtype=dt, device=dev)
        Uu = torch.zeros((m + 1, m + 1), dtype=dt, device=dev)
        cycle_solution_applied = False

        for it in range(1, m + 1):
            gidx = (cycle - 1) * restart + it
            if gidx > maxit or done:
                break
            w = V[it - 1]
            mv = psolve(w) if psolve is not None else w
            av = matvec(mv)
            # modified Gram-Schmidt (iter.f:171-183)
            for i in range(1, it + 1):
                s = (V[i - 1] * av).sum()
                H[i - 1, it - 1] = s
                av = av - s * V[i - 1]
            hlast = _norm(av)
            H[it, it - 1] = hlast
            V[it] = av / hlast
            # QR column update (iter.f:192-210)
            for i in range(1, it):
                s = (Q[: i + 1, i - 1] * H[: i + 1, it - 1]).sum()
                Uu[i - 1, it - 1] = s
                H[: i + 1, it - 1] = H[: i + 1, it - 1] - s * Q[: i + 1, i - 1]
            udiag = torch.sqrt((H[: it + 1, it - 1] ** 2).sum())
            Uu[it - 1, it - 1] = udiag
            Q[: it + 1, it - 1] = H[: it + 1, it - 1] / udiag
            # orthonormal last column (iter.f:213-230)
            qcol = torch.zeros(m + 1, dtype=dt, device=dev)
            qcol[0] = 1.0
            for i in range(1, it + 1):
                s = (Q[:i, i - 1] * qcol[:i]).sum()
                qcol[: i + 1] = qcol[: i + 1] - s * Q[: i + 1, i - 1]
            qnorm2 = (qcol[: it + 1] ** 2).sum()
            # the reference normalizes only element 1 (iter.f:228)
            q1 = qcol[0] / torch.sqrt(qnorm2)
            Q[: it + 1, it] = qcol[: it + 1]
            Q[0, it] = q1
            est = err1 * torch.abs(q1)
            hist[gidx - 1] = est

            conv = bool(est < tol * err0)  # the one read-back of the iteration
            solve_now = conv or it == m or gidx == maxit
            stop_now = conv or gidx == maxit
            if solve_now and not cycle_solution_applied:
                # solution update (iter.f:236-266): usolve U c = q(1,:)*err1,
                # combination of V columns, optional psolve, x -= z, r -= A z
                rhs_c = Q[0, :it] * err1
                c = _usolve(Uu, rhs_c, it)
                comb = (c[:, None] * V[:it]).sum(dim=0)
                z = psolve(comb) if psolve is not None else comb
                x = x - z
                r = r - matvec(z)
                cycle_solution_applied = True
                done = stop_now
    return x, hist


def _usolve(Uu, rhs, it):
    """Back substitution with the it x it upper-triangular QR factor
    (iter.f usolve)."""
    c = torch.zeros(it, dtype=rhs.dtype, device=rhs.device)
    for i in range(it - 1, -1, -1):
        s = rhs[i] - (Uu[i, i + 1 : it] * c[i + 1 : it]).sum()
        c[i] = s / Uu[i, i]
    return c
