"""Conjugate-gradient solvers.

Counterpart of lilac_tpu/solvers/cg.py. `npb_conj_grad` reproduces the NPB
CG inner solve exactly: same update order, fixed 25 iterations, explicit
final residual (cg.f:447-639). `npb_power_method` is the outer
inverse-power iteration with the zeta update (cg.f:299-349). `cg_solve` is
the general residual-tolerance CG of SparseBench-style workloads.

The loops are Python loops over eager tensor ops. The NPB loops read
nothing back to the host, so the device queue stays ahead of the
interpreter and the caller fetches the histories once. `cg_solve` reads
its stopping test back once an iteration (the reference's
lax.while_loop predicate): that read is its only one.
"""

from __future__ import annotations

from typing import Callable

import torch

from lilac_tpu_torch.ops.dfloat import DF
from lilac_tpu_torch.utils.profiling import span

_STEP = span("lilac.solver.step")
_ITER = span("lilac.solver.iter")
_RESIDUAL = span("lilac.solver.residual")


def npb_conj_grad(matvec: Callable, alg, A, x, cgitmax: int = 25):
    """One NPB conj_grad call: returns (z, rnorm) per cg.f:447-639."""
    z = alg.zeros_like(x)
    r = x
    p = r
    rho = alg.dot(r, r)

    for _ in range(cgitmax):
        with _ITER:
            q = matvec(A, p)
            d = alg.dot(p, q)
            alpha = alg.sdiv(rho, d)
            z = alg.add(z, alg.smul(alpha, p))
            r = alg.sub(r, alg.smul(alpha, q))
            rho_new = alg.dot(r, r)
            beta = alg.sdiv(rho_new, rho)
            p = alg.add(r, alg.smul(beta, p))
            rho = rho_new

    with _RESIDUAL:
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
        with _STEP:
            z, rnorm = npb_conj_grad(matvec, alg, A, x, cgitmax)
            norm1 = alg.dot(x, z)
            norm2 = alg.dot(z, z)
            zetas.append(alg.add(shift_s, alg.sdiv(one, norm1)))
            rnorms.append(rnorm)
            x = alg.smul(alg.sdiv(one, alg.ssqrt(norm2)), z)
    return alg.stack(zetas), alg.stack(rnorms), x


def cg_solve(
    matvec: Callable,
    alg,
    A,
    b,
    x0=None,
    *,
    maxit: int = 100,
    rtol: float = 1e-6,
    precond: Callable | None = None,
):
    """Preconditioned CG with SparseBench's stopping rule (iter_symm.f:18):
    iterate until ||r||_2 <= rtol * ||r0||_2 or maxit, the test made on the
    f32 view of the two norms (_as_f32), as the reference makes it.

    Returns (x, iterations, final_residual_norm), iterations a Python int.
    `precond(A, r)` applies M^-1 (identity if None)."""
    if x0 is None:
        x0 = alg.zeros_like(b)
    psolve = precond if precond is not None else (lambda A, r: r)

    r = alg.sub(b, matvec(A, x0))
    z = psolve(A, r)
    p = z
    rho = alg.dot(r, z)
    rnorm = alg.ssqrt(alg.dot(r, r))
    tol = alg.smul(alg.scalar(rtol), rnorm)
    x = x0
    it = 0
    while it < maxit and bool(_as_f32(alg, rnorm) > _as_f32(alg, tol)):
        q = matvec(A, p)
        d = alg.dot(p, q)
        alpha = alg.sdiv(rho, d)
        x = alg.add(x, alg.smul(alpha, p))
        r = alg.sub(r, alg.smul(alpha, q))
        z = psolve(A, r)
        rho_new = alg.dot(r, z)
        beta = alg.sdiv(rho_new, rho)
        p = alg.add(z, alg.smul(beta, p))
        rnorm = alg.ssqrt(alg.dot(r, r))
        rho = rho_new
        it += 1
    return x, it, rnorm


def _as_f32(alg, s) -> torch.Tensor:
    """Comparable f32 view of an algebra scalar (for the stopping test): a
    df64 number's hi word, a plain scalar cast."""
    if isinstance(s, DF):
        return s.hi
    return s.to(torch.float32)
