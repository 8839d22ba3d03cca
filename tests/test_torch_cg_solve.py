"""cg_solve of lilac_tpu_torch against the JAX package's: the same seeded
SPD matrix through the ELL gather kernel of each package, in f32, f64 and
df64, with and without a diagonal preconditioner given to both, and a
run cut at maxit.

The iteration counts must be equal (the stopping test is made on the f32
view of the norms in both packages). x and the final residual norm are
compared relative to max|x| and ||b||: 1e-4 in f32 (its sums round in
another order in XLA and torch, and CG amplifies that by the condition
number), 1e-12 in f64 and df64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lilac_tpu.formats import convert as jconv
from lilac_tpu.formats.sparse import ELL as JELL
from lilac_tpu.kernels import xla as jxla
from lilac_tpu.ops import dfloat as jdf
from lilac_tpu.solvers import algebra as jalg
from lilac_tpu.solvers import cg as jcg
from lilac_tpu_torch.formats import convert as tconv
from lilac_tpu_torch.formats.sparse import ELL as TELL
from lilac_tpu_torch.kernels import gather as tgather
from lilac_tpu_torch.ops import dfloat as tdf
from lilac_tpu_torch.solvers import algebra as talg
from lilac_tpu_torch.solvers import cg as tcg

torch.set_num_threads(1)

TOL = {"f32": 1e-4, "f64": 1e-12, "df64": 1e-12}
NP_DTYPE = {"f32": np.float32, "f64": np.float64}


def _spd(n=300, seed=5):
    """A sparse SPD matrix with a spread diagonal (so that a diagonal
    preconditioner changes the iteration), as host CSR, and b."""
    rng = np.random.default_rng(seed)
    k = 6
    rows = np.repeat(np.arange(n), k)
    cols = rng.integers(0, n, size=n * k)
    vals = rng.standard_normal(n * k) * 0.5
    # B + B^T + a diagonal that dominates each row
    r = np.concatenate([rows, cols, np.arange(n)])
    c = np.concatenate([cols, rows, np.arange(n)])
    diag = np.zeros(n)
    np.add.at(diag, rows, np.abs(vals))
    np.add.at(diag, cols, np.abs(vals))
    d = 1.0 + diag + 10.0 ** rng.uniform(0, 2, size=n)
    v = np.concatenate([vals, vals, d])
    indptr, indices, data = jconv.coo_to_csr_arrays(r, c, v, (n, n))
    return indptr, indices, data, d, rng.standard_normal(n)


def _ell_pair(indptr, indices, data, n, dtype):
    """The same ELL in both packages: f32 / f64 values, or df64 pairs."""
    if dtype == "df64":
        v, c = jconv.csr_to_ell_arrays(indptr, indices, tdf.split_f64_np(data), (n, n))
    else:
        v, c = jconv.csr_to_ell_arrays(indptr, indices, data.astype(NP_DTYPE[dtype]), (n, n))
    J = JELL(data=jnp.asarray(v), indices=jnp.asarray(c), shape=(n, n))
    T = TELL(data=torch.as_tensor(v), indices=torch.as_tensor(c, dtype=torch.int64),
             shape=(n, n))
    return J, T


def _solve_both(dtype, precond, maxit, rtol):
    indptr, indices, data, d, b = _spd()
    n = len(b)
    J, T = _ell_pair(indptr, indices, data, n, dtype)
    dinv = 1.0 / d
    if dtype == "df64":
        jalg_, talg_ = jalg.DF64Alg(), talg.get_algebra("df64", device="cpu")
        jmv, tmv = jxla.ell_spmv_df, tgather.ell_spmv_df
        jb, tb = jdf.from_f64(b), tdf.from_f64(b, device="cpu")
        jd, td = jdf.from_f64(dinv), tdf.from_f64(dinv, device="cpu")
        jpre = (lambda A, r: jdf.mul(jd, r)) if precond else None
        tpre = (lambda A, r: tdf.mul(td, r)) if precond else None
    else:
        npd = NP_DTYPE[dtype]
        jalg_ = jalg.get_algebra(dtype)
        talg_ = talg.get_algebra(dtype, device="cpu")
        jmv, tmv = jxla.ell_spmv, tgather.ell_spmv
        jb, tb = jnp.asarray(b.astype(npd)), torch.as_tensor(b.astype(npd))
        jd, td = jnp.asarray(dinv.astype(npd)), torch.as_tensor(dinv.astype(npd))
        jpre = (lambda A, r: jd * r) if precond else None
        tpre = (lambda A, r: td * r) if precond else None
    jx, jit, jr = jcg.cg_solve(jmv, jalg_, J, jb, maxit=maxit, rtol=rtol, precond=jpre)
    tx, tit, tr = tcg.cg_solve(tmv, talg_, T, tb, maxit=maxit, rtol=rtol, precond=tpre)
    if dtype == "df64":
        jx, tx = jdf.to_f64(jx), tdf.to_f64(tx)
        jr, tr = float(jdf.to_f64(jr)), float(tdf.to_f64(tr))
    else:
        jx, tx = np.asarray(jx, np.float64), tx.numpy().astype(np.float64)
        jr, tr = float(jr), float(tr)
    return (jx, int(jit), jr), (tx, tit, tr), b


@pytest.mark.parametrize("precond", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "f64", "df64"])
def test_cg_solve_matches_reference(dtype, precond):
    rtol = 1e-5 if dtype == "f32" else 1e-10
    (jx, jit, jr), (tx, tit, tr), b = _solve_both(dtype, precond, maxit=500, rtol=rtol)
    assert isinstance(tit, int) and tit == jit and 0 < tit < 500
    assert np.abs(tx - jx).max() <= TOL[dtype] * np.abs(jx).max()
    bnorm = np.linalg.norm(b)
    assert abs(tr - jr) <= TOL[dtype] * bnorm
    assert tr <= rtol * bnorm * (1 + 1e-6)  # stopped by the test, at its f32 view


def test_cg_solve_stops_at_maxit():
    """A run cut at maxit returns maxit and the same partial x."""
    (jx, jit, jr), (tx, tit, tr), b = _solve_both("f64", False, maxit=3, rtol=1e-14)
    assert tit == jit == 3
    np.testing.assert_allclose(tx, jx, rtol=0, atol=1e-12 * np.abs(jx).max())
    assert tr > 1e-14 * np.linalg.norm(b) and abs(tr - jr) <= 1e-12 * np.linalg.norm(b)


def test_cg_solve_with_x0_and_the_f32_view():
    """A given x0 is the start (one product of the solution itself: no
    iteration); _as_f32 is the df64 number's hi word, a plain scalar cast."""
    indptr, indices, data, d, b = _spd()
    n = len(b)
    _, T = _ell_pair(indptr, indices, data, n, "f64")
    alg = talg.get_algebra("f64", device="cpu")
    x, it, _ = tcg.cg_solve(tgather.ell_spmv, alg, T, torch.as_tensor(b), rtol=1e-8)
    x2, it2, r2 = tcg.cg_solve(tgather.ell_spmv, alg, T, tgather.ell_spmv(T, x), x0=x,
                               rtol=1e-8)
    assert it > 0 and it2 == 0 and torch.equal(x2, x)
    s = tdf.from_f64(np.asarray(1.0 + 2.0 ** -30), device="cpu")
    assert tcg._as_f32(talg.DF64Alg("cpu"), s) is s.hi
    assert tcg._as_f32(alg, torch.tensor(0.1, dtype=torch.float64)).dtype == torch.float32
