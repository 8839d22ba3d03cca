"""Conjugate-gradient solvers.

Counterpart of lilac_tpu/solvers/cg.py. `npb_conj_grad` reproduces the NPB
CG inner solve exactly: same update order, fixed 25 iterations, explicit
final residual (cg.f:447-639). `npb_power_method` is the outer
inverse-power iteration with the zeta update (cg.f:299-349). The general
residual-tolerance `cg_solve` is not ported yet.

The loops are Python loops over eager tensor ops: nothing is read back to
the host inside them, so the device queue stays ahead of the interpreter
and the caller fetches the histories once.
"""

from __future__ import annotations

from typing import Callable


def npb_conj_grad(matvec: Callable, alg, A, x, cgitmax: int = 25):
    """One NPB conj_grad call: returns (z, rnorm) per cg.f:447-639."""
    z = alg.zeros_like(x)
    r = x
    p = r
    rho = alg.dot(r, r)

    for _ in range(cgitmax):
        q = matvec(A, p)
        d = alg.dot(p, q)
        alpha = alg.sdiv(rho, d)
        z = alg.add(z, alg.smul(alpha, p))
        r = alg.sub(r, alg.smul(alpha, q))
        rho_new = alg.dot(r, r)
        beta = alg.sdiv(rho_new, rho)
        p = alg.add(r, alg.smul(beta, p))
        rho = rho_new

    az = matvec(A, z)
    d = alg.sub(x, az)
    rnorm = alg.ssqrt(alg.dot(d, d))
    return z, rnorm


def npb_power_method(
    matvec: Callable, alg, A, x0, shift: float, niter: int, cgitmax: int = 25
):
    """NPB CG outer loop (cg.f:299-349): niter inverse-power iterations.

    Returns (zeta_history, rnorm_history, x_final): zeta / rnorm as the
    algebra's scalar type, stacked over iterations, still on the device.
    """
    shift_s = alg.scalar(shift)
    one = alg.scalar(1.0)
    x = x0
    zetas, rnorms = [], []
    for _ in range(niter):
        z, rnorm = npb_conj_grad(matvec, alg, A, x, cgitmax)
        norm1 = alg.dot(x, z)
        norm2 = alg.dot(z, z)
        zetas.append(alg.add(shift_s, alg.sdiv(one, norm1)))
        rnorms.append(rnorm)
        x = alg.smul(alg.sdiv(one, alg.ssqrt(norm2)), z)
    return alg.stack(zetas), alg.stack(rnorms), x
