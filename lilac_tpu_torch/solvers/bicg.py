"""BiConjugate Gradient solver (SparseBench semantics).

Counterpart of lilac_tpu/solvers/bicg.py. Reproduces the SparseBench bicg
algorithm (SparseBench/SRC/reference/iter.f:18-104):

* initial residual r = A·x − rhs (their sign convention), rl = r;
* convergence test at the TOP of the loop: stop when ||r|| < rtol·||r0||,
  compared on the f32 views of the two norms (the hi word of a df64
  number), reporting `its` = the iteration index at which the test fired;
* rr = (r, zl); β = rr/rr_prev; p = z + β·p (and the shadow sequence);
* α = rr / (pl, A·p); x ← x − α·p; r ← r − α·A·p; rl ← rl − α·Aᵀ·pl;
* non-convergence encoded as negative its.

Uses the TRUE transpose product Aᵀ·pl (the harnessed reference substituted
A for Aᵀ, random.f:50-88 at :72).

Preconditioning: psolve(A, v, 'n'|'t') applies M⁻¹ / M⁻ᵀ.

The JAX package's `lax.while_loop` is a Python loop over eager torch ops
here. Each iteration reads one predicate back to the host, the
convergence test; nothing else is read. `hist` is float32, as in the
reference.

Spans: `lilac.solver.step` around each iteration (the norm through the
update of rl), `lilac.solver.test` around its one read-back.
"""

from __future__ import annotations

from typing import Callable

import torch

from lilac_tpu_torch.ops.dfloat import DF
from lilac_tpu_torch.utils.profiling import span

_STEP = span("lilac.solver.step")
_TEST = span("lilac.solver.test")


def bicg_solve(
    matvec: Callable,
    matvec_t: Callable,
    alg,
    A,
    rhs,
    x0,
    *,
    maxit: int = 100,
    rtol: float = 1e-6,
    psolve: Callable | None = None,
    state: tuple | None = None,
    stop_at: int | None = None,
):
    """Returns (x, its, hist, rn_final, state): hist is the [maxit]
    residual-norm history (zeros past convergence); its > 0 iff converged,
    matching the reference's sign convention; its is a Python int.

    `state` / `stop_at`: pass stop_at=k to pause after iteration k and feed
    the returned state back in; the iterate path is identical to an
    unchunked run, bit for bit."""
    precond = psolve is not None

    def zl_pair(r, rl):
        if precond:
            return psolve(A, r, "n"), psolve(A, rl, "t")
        return r, rl

    limit = maxit if stop_at is None else min(int(stop_at), maxit)
    if state is None:
        r0vec = alg.sub(matvec(A, x0), rhs)
        dev = r0vec.hi.device if isinstance(r0vec, DF) else r0vec.device
        hist0 = torch.zeros(maxit, dtype=torch.float32, device=dev)
        state = (x0, r0vec, r0vec, alg.zeros_like(x0), alg.zeros_like(x0),
                 alg.scalar(1.0), 0, False, alg.scalar(0.0), hist0)
    x, r, rl, p, pl, rr, it, done, rn0, hist = state
    hist = hist.clone()  # the state handed in stays as it was
    rtol_s = alg.scalar(rtol)

    while it < limit and not done:
        with _STEP:
            rn = alg.ssqrt(alg.dot(r, r))
            hist[it] = _scal(alg, rn)
            first = it == 0
            if first:
                rn0 = rn
            # convergence threshold in the algebra's native precision; the
            # reference freezes every update once it holds and leaves the loop
            thresh = alg.smul(rtol_s, rn0)
            it += 1
            with _TEST:  # the one read-back of the iteration
                done = bool(_lt(alg, rn, thresh))
            if done:
                break

            z, zl = zl_pair(r, rl)
            rr_new = alg.dot(r, zl)
            if first:
                p_new, pl_new = z, zl
            else:
                beta = alg.sdiv(rr_new, rr)
                p_new = alg.add(alg.smul(beta, p), z)
                pl_new = alg.add(alg.smul(beta, pl), zl)

            ap = matvec(A, p_new)
            apl = matvec_t(A, pl_new)
            alpha = alg.sdiv(rr_new, alg.dot(pl_new, ap))
            x = alg.sub(x, alg.smul(alpha, p_new))
            r = alg.sub(r, alg.smul(alpha, ap))
            rl = alg.sub(rl, alg.smul(alpha, apl))
            p, pl, rr = p_new, pl_new, rr_new

    out = (x, r, rl, p, pl, rr, it, done, rn0, hist)
    rn_final = alg.ssqrt(alg.dot(r, r))
    its = it if done else -it
    return x, its, hist, rn_final, out


def _scal(alg, s):
    """The f32 view of an algebra scalar (a df64 number's hi word)."""
    if isinstance(s, DF):
        return s.hi.to(torch.float32)
    return s.to(torch.float32)


def _lt(alg, a, b):
    """a < b on algebra scalars via their comparable f32 views."""
    return _scal(alg, a) < _scal(alg, b)
