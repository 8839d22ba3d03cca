"""SparseBench in lilac_tpu_torch against the JAX package: generators,
readers, the golden protocol, the solvers and the timed BiCG protocol.

* Host arrays (random_crs, the DLARAN generators, Cuthill-McKee, the
  relabel, the readers) are the JAX package's bit for bit.
* The golden rows of size 10 reproduce: iterations exact, residual within
  1e-2 relative (the reference's own test bound; the 5% contract of
  Scripts/validate.pl is looser). Size 20 stays `slow`, as in the JAX
  package; it runs on the card in chip_smoke.py.
* The faithful solvers' histories agree with the JAX package's to 1e-10
  relative (f64, sums in another order).
* bicg_solve: the same its, hist to 1e-6 relative (hist is f32 in both
  packages; 1e-4 for a solve in f32 arithmetic, whose sums round in
  another order in each package), x to 1e-4 (f32) / 1e-9 (f64, df64) of
  max |x|.
* gmres_solve: the same its, the estimates to 1e-6 relative until the
  first falls to 1e-4 of the first estimate: from there the estimate is
  the small remainder of e1 orthogonalised against Q's columns, which lose
  their orthogonality, and the two packages' orders of summation round it
  differently (5% apart at the end of a cycle).
* The timed protocol on the CPU serves the routed kernels (K1, K11; K3-K10
  in the forced hierarchical case) through their plain versions.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lilac_tpu.formats import convert as jconv
from lilac_tpu.generate import random_crs as jrc
from lilac_tpu.generate import sparsebench_gen as jgen
from lilac_tpu.io import readers as jrd
from lilac_tpu.ops import dfloat as jdf
from lilac_tpu.plan import SpmvPlan as JPlan
from lilac_tpu.plan import transposed_plan as jtransposed
from lilac_tpu.solvers import algebra as jalg
from lilac_tpu.solvers import bicg as jbicg
from lilac_tpu.solvers import gmres as jgmres
from lilac_tpu.solvers import sb_iter as jsb_iter
from lilac_tpu.workloads import sparsebench as jsb
from lilac_tpu_torch import bench as tbench
from lilac_tpu_torch import native as tnative
from lilac_tpu_torch.formats import convert as tconv
from lilac_tpu_torch.generate import random_crs as trc
from lilac_tpu_torch.generate import sparsebench_gen as tgen
from lilac_tpu_torch.io import readers as trd
from lilac_tpu_torch.ops import dfloat as tdf
from lilac_tpu_torch.plan import SpmvPlan as TPlan
from lilac_tpu_torch.plan import transposed_plan as ttransposed
from lilac_tpu_torch.solvers import algebra as talg
from lilac_tpu_torch.solvers import bicg as tbicg
from lilac_tpu_torch.solvers import gmres as tgmres
from lilac_tpu_torch.solvers import sb_iter as tsb_iter
from lilac_tpu_torch.workloads import sparsebench as tsb

torch.set_num_threads(1)


def _same(got, want):
    """Two tuples of host arrays (or a dict of them) equal bit for bit."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _same(got[k], want[k])
        return
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    else:
        assert got == want


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.abs(want)))


# -- generators ----------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("size", [5, 10])
def test_random_crs_bit_identical(size, seed):
    _same(trc.random_crs(size, seed=seed), jrc.random_crs(size, seed=seed))


def test_dlaran_take_equals_next():
    a, b, ref = tgen.DLaran(), tgen.DLaran(), jgen.DLaran()
    got = a.take(1000)
    assert np.array_equal(got, np.array([b.next() for _ in range(1000)]))
    assert np.array_equal(got, ref.take(1000)) and a.x == b.x == ref.x
    assert a.take(0).shape == (0,)


@pytest.mark.parametrize("sym", [True, False])
def test_native_fill_equals_python_fill(sym):
    """The port's C copy of the gen_crs fill loop consumes the DLARAN stream
    as the Python loop does: the same entries, diagonal and final state."""
    n = 125
    splits = tgen.make_blocks(n, 0.3, tgen.DLaran())
    assert splits == jgen.make_blocks(n, 0.3, jgen.DLaran())
    rng = tgen.DLaran()
    r, c, v = tgen.fill_matrix(splits, n, rng, sym=sym)
    cr, cc, cv, diag, state = tnative.sb_fill_matrix(
        np.asarray(splits, dtype=np.int64), n, sym, tgen.DLaran().x)
    assert state == rng.x
    assert np.array_equal(r, np.concatenate([np.arange(1, n + 1), cr]))
    assert np.array_equal(c, np.concatenate([np.arange(1, n + 1), cc]))
    assert np.array_equal(v, np.concatenate([diag, cv]))


@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("side", [5, 10])
def test_generate_crs_and_crs_system_bit_identical(side, sym):
    _same(tgen.generate_crs(side, sym=sym), jgen.generate_crs(side, sym=sym))
    _same(tgen.crs_system(side, sym=sym), jgen.crs_system(side, sym=sym))


@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("side", [5, 10])
def test_regular_system_bit_identical(side, sym):
    _same(tgen.regular_system(side, sym), jgen.regular_system(side, sym))


@pytest.mark.parametrize("bjacobi", [False, True])
@pytest.mark.parametrize("sym", [True, False])
def test_regular_parts_bit_identical(sym, bjacobi):
    _same(tgen.regular_parts(5, sym, bjacobi=bjacobi),
          jgen.regular_parts(5, sym, bjacobi=bjacobi))


def test_cuthill_mckee_and_stencil_bit_identical():
    from lilac_tpu.generate.stencil import seven_point_csr as jseven
    from lilac_tpu_torch.generate.stencil import seven_point_csr as tseven

    ip, ix, _, shape = jgen.generate_crs(5)
    _same(tgen.cuthill_mckee(ip, ix + 1, shape[0]), jgen.cuthill_mckee(ip, ix + 1, shape[0]))
    _same(tseven(4, 3, 5), jseven(4, 3, 5))
    _same(tseven(3, 3), jseven(3, 3))


@pytest.mark.parametrize("size", [5, 10])
def test_length_relabel_csr_bit_identical(size):
    m = jrc.random_crs(size, seed=1)
    got = tconv.length_relabel_csr(*m)
    _same(got, jconv.length_relabel_csr(*m))
    ip, ix, dv, order, rank = got
    # a similarity: A'[rank[i], rank[j]] = A[i, j], rows by descending length
    assert np.all(np.diff(np.diff(ip)) <= 0)
    assert np.array_equal(order[rank], np.arange(len(order)))


def test_coo_to_csr_arrays_bit_identical():
    rng = np.random.default_rng(2)
    r, c = rng.integers(0, 40, 300), rng.integers(0, 30, 300)
    v = rng.normal(size=300)
    for dup in (True, False):
        _same(tconv.coo_to_csr_arrays(r, c, v, (40, 30), sum_duplicates=dup),
              jconv.coo_to_csr_arrays(r, c, v, (40, 30), sum_duplicates=dup))


# -- readers -----------------------------------------------------------------


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_sparsebench_crs_files_interchange(tmp_path, writer):
    """A file written by either package reads to the same arrays in both,
    and to the matrix that was written."""
    ip, ix, dv, shape = jrc.random_crs(5, seed=4)
    path = str(tmp_path / "m.crs")
    (trd if writer == "port" else jrd).write_sparsebench_crs(path, ip, ix, dv, shape)
    got = trd.read_sparsebench_crs(path)
    _same(got, jrd.read_sparsebench_crs(path))
    assert got[3] == shape
    assert np.array_equal(got[0], ip) and np.array_equal(got[1], ix)
    np.testing.assert_allclose(got[2], dv, rtol=1e-15)
    with open(path, "a") as f:
        f.write("1 2.0\n")
    with pytest.raises(ValueError, match="token count"):
        trd.read_sparsebench_crs(path)


# -- the golden protocol ---------------------------------------------------------

SIZE10 = sorted(k for k in jsb.GOLDEN if k[1] == 10)
SIZE20 = sorted(k for k in jsb.GOLDEN if k[1] == 20)


def test_golden_table_and_constants_are_the_reference():
    assert tsb.GOLDEN == jsb.GOLDEN and len(tsb.GOLDEN) == 20
    assert (tsb.MAXIT, tsb.RTOL) == (jsb.MAXIT, jsb.RTOL)


@pytest.mark.parametrize("case", SIZE10, ids=lambda c: "-".join(map(str, c)))
def test_golden_size10(case):
    r = tsb.run_case(*case, device="cpu")
    assert r.iterations == r.golden[0], (r.iterations, r.golden)
    assert r.validated and r.residual_rel_err <= 1e-2, (r.residual, r.golden)


@pytest.mark.slow
@pytest.mark.parametrize("case", SIZE20, ids=lambda c: "-".join(map(str, c)))
def test_golden_size20(case):
    r = tsb.run_case(*case, device="cpu")
    assert r.iterations == r.golden[0]
    assert r.residual_rel_err <= 0.05


@pytest.mark.parametrize("case", [("s", 2, 2), ("s", 1, 0), ("u", 1, 2), ("u", 2, 0)])
def test_faithful_solver_histories_match_jax(case):
    """sb_cg (sym) and sb_gmres (unsym) on one size-10 case each, with and
    without a preconditioner: the histories to 1e-10 relative, the same
    stopping iteration (hist zeros past it) and sign of its."""
    sym, structure, prec = case
    tmv, tps, n, _ = tsb.build_case(sym, 10, structure, prec, device="cpu")
    jmv, jps, _, _ = jsb.build_case(sym, 10, structure, prec)
    tb, jb = torch.ones(n, dtype=torch.float64), jnp.ones(n, jnp.float64)
    if sym == "s":
        tx, th, tits = tsb_iter.sb_cg(tmv, tb, maxit=12, rtol=1e-6, psolve=tps)
        jx, jh, jits = jax.jit(
            lambda b: jsb_iter.sb_cg(jmv, b, maxit=12, rtol=1e-6, psolve=jps))(jb)
        assert tits == int(jits)
    else:
        tx, th = tsb_iter.sb_gmres(tmv, tb, restart=10, maxit=12, tol=1e-6, psolve=tps)
        jx, jh = jax.jit(lambda b: jsb_iter.sb_gmres(
            jmv, b, restart=10, maxit=12, tol=1e-6, psolve=jps))(jb)
    th, jh = th.numpy(), np.asarray(jh)
    assert np.array_equal(th == 0, jh == 0)
    nz = jh != 0
    assert _rel(th[nz], jh[nz]) <= 1e-10
    assert _rel(tx.numpy(), np.asarray(jx)) <= 1e-9


def test_sb_cg_converges_and_counts_positive():
    """A tolerance the case reaches: its > 0 at the stopping iteration,
    hist zero past it, in both packages."""
    tmv, tps, n, _ = tsb.build_case("s", 10, 2, 2, device="cpu")
    jmv, jps, _, _ = jsb.build_case("s", 10, 2, 2)
    _, th, tits = tsb_iter.sb_cg(tmv, torch.ones(n, dtype=torch.float64), maxit=40,
                                 rtol=1e-9, psolve=tps)
    _, jh, jits = jsb_iter.sb_cg(jmv, jnp.ones(n, jnp.float64), maxit=40, rtol=1e-9,
                                 psolve=jps)
    assert 0 < tits == int(jits) < 40
    assert np.all(th.numpy()[tits:] == 0) and th.numpy()[tits - 1] > 0


def test_validate_large_oracle():
    r = tsb.validate_large(sizes=(5,), maxit=20, verbose=False, device="cpu")
    assert len(r) == 2 and all(ok for _, ok, _ in r), r
    assert max(g for _, _, g in r) <= 1e-8


# -- bicg_solve / gmres_solve -----------------------------------------------------


def _unsym(n=48, seed=7):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(n, n)) * (rng.random((n, n)) < 0.2)
    A = M + n * np.eye(n) * (1.0 + rng.random(n))[:, None]
    r, c = np.nonzero(A)
    return jconv.coo_to_csr_arrays(r, c, A[r, c], (n, n)), A


def _bicg_pair(dtype, precond, **kw):
    """bicg_solve of both packages on the same matrix through ELL (A and Aᵀ
    each its own plan), b = 1, x0 = 0; with `precond`, Jacobi for M⁻¹ and
    M⁻ᵀ alike."""
    (ip, ix, dv), A = _unsym()
    n = A.shape[0]
    kernel = "xla_ell_df" if dtype == "df64" else "xla_ell"
    jp = JPlan(ip, ix, dv, (n, n), dtype=dtype, kernel=kernel)
    jpt = jtransposed(ip, ix, dv, (n, n), dtype=dtype, kernel=kernel)
    tp = TPlan(ip, ix, dv, (n, n), dtype=dtype, kernel=kernel, device="cpu")
    tpt = ttransposed(ip, ix, dv, (n, n), dtype=dtype, kernel=kernel, device="cpu")
    dinv = 1.0 / np.diag(A)
    if dtype == "df64":
        jd, td = jdf.from_f64(dinv), tdf.from_f64(dinv, device="cpu")
        jpre = (lambda A_, v, mode: jdf.mul(jd, v)) if precond else None
        tpre = (lambda A_, v, mode: tdf.mul(td, v)) if precond else None
        jalg_, talg_ = jalg.DF64Alg(), talg.get_algebra("df64", device="cpu")
    else:
        dt = {"f32": (jnp.float32, torch.float32), "f64": (jnp.float64, torch.float64)}
        jd, td = jnp.asarray(dinv, dt[dtype][0]), torch.as_tensor(dinv, dtype=dt[dtype][1])
        jpre = (lambda A_, v, mode: jd * v) if precond else None
        tpre = (lambda A_, v, mode: td * v) if precond else None
        jalg_, talg_ = jalg.get_algebra(dtype), talg.get_algebra(dtype, device="cpu")
    b, x0 = np.ones(n), np.zeros(n)
    jres = jax.jit(lambda As, b_, x0_: jbicg.bicg_solve(
        lambda A_, v: jp.matvec_with(A_[0], v), lambda A_, v: jpt.matvec_with(A_[1], v),
        jalg_, As, b_, x0_, psolve=jpre, **kw))((jp.A, jpt.A), jp.vec_in(b), jp.vec_in(x0))
    tres = tbicg.bicg_solve(
        lambda A_, v: tp.matvec_with(A_[0], v), lambda A_, v: tpt.matvec_with(A_[1], v),
        talg_, (tp.A, tpt.A), tp.vec_in(b), tp.vec_in(x0), psolve=tpre, **kw)
    return jp, tp, jres, tres, A


@pytest.mark.parametrize("precond", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "f64", "df64"])
def test_bicg_matches_jax(dtype, precond):
    rtol = 1e-5 if dtype == "f32" else 1e-12
    jp, tp, (jx, jits, jh, jrn, _), (tx, tits, th, trn, _), A = _bicg_pair(
        dtype, precond, maxit=60, rtol=rtol)
    assert tits == int(jits) > 0, (tits, int(jits))
    assert th.dtype == torch.float32
    th, jh = th.numpy(), np.asarray(jh)
    assert np.array_equal(th == 0, jh == 0)
    assert _rel(th[: tits], jh[: tits]) <= (1e-4 if dtype == "f32" else 1e-6)
    xt, xj = tp.vec_out(tx), jp.vec_out(jx)
    tol = 1e-4 if dtype == "f32" else 1e-9
    assert np.abs(xt - xj).max() <= tol * np.abs(xj).max()
    # reference sign convention: r = A x - b, so x solves A x = b up to sign
    ref = np.linalg.solve(A, np.ones(A.shape[0]))
    assert min(np.abs(xt - ref).max(), np.abs(xt + ref).max()) <= 1e3 * tol * np.abs(ref).max()


@pytest.mark.parametrize("dtype", ["f64", "df64"])
def test_bicg_pause_and_resume_equals_unchunked(dtype):
    """stop_at = k pauses after iteration k; the state handed back resumes
    to the unchunked run's result bit for bit (and the state handed in is
    left as it was)."""
    _, tp, _, (x, its, hist, rn, _), _ = _bicg_pair(dtype, True, maxit=12, rtol=1e-30)
    (ip, ix, dv), A = _unsym()
    n = A.shape[0]
    kernel = "xla_ell_df" if dtype == "df64" else "xla_ell"
    tpt = ttransposed(ip, ix, dv, (n, n), dtype=dtype, kernel=kernel, device="cpu")
    alg = talg.get_algebra(dtype, device="cpu")
    if dtype == "df64":
        td = tdf.from_f64(1.0 / np.diag(A), device="cpu")
        pre = lambda A_, v, mode: tdf.mul(td, v)  # noqa: E731
    else:
        td = torch.as_tensor(1.0 / np.diag(A))
        pre = lambda A_, v, mode: td * v  # noqa: E731
    args = (lambda A_, v: tp.matvec_with(A_[0], v), lambda A_, v: tpt.matvec_with(A_[1], v),
            alg, (tp.A, tpt.A), tp.vec_in(np.ones(n)), tp.vec_in(np.zeros(n)))
    state = None
    for k in (3, 8, 12):
        xc, itc, hc, rnc, state = tbicg.bicg_solve(*args, maxit=12, rtol=1e-30,
                                                   psolve=pre, state=state, stop_at=k)
        assert itc == -k
    assert itc == its == -12 and bool(torch.isfinite(hist).all())
    assert torch.equal(hc, hist)
    assert np.array_equal(tp.vec_out(xc), tp.vec_out(x))
    assert np.array_equal(np.asarray(alg.to_f64(rnc)), np.asarray(alg.to_f64(rn)))


def _estimates_head(est) -> int:
    """How many leading GMRES estimates exceed 1e-4 of the first."""
    small = np.nonzero(est <= 1e-4 * est[0])[0]
    return int(small[0]) if len(small) else len(est)


def test_gmres_matches_jax_and_dense_solve():
    """The production restarted GMRES: the same its and estimates as the JAX
    package's, x within 1e-10 of it and 1e-8 of a dense solve."""
    rng = np.random.default_rng(1234)
    n = 40
    M = rng.normal(size=(n, n)) * (rng.random((n, n)) < 0.25)
    A = M + n * np.eye(n)
    r, c = np.nonzero(A)
    ip, ix, dv = jconv.coo_to_csr_arrays(r, c, A[r, c], (n, n))
    jp = JPlan(ip, ix, dv, (n, n), dtype="f64", kernel="xla_ell")
    tp = TPlan(ip, ix, dv, (n, n), dtype="f64", kernel="xla_ell", device="cpu")
    ref = np.linalg.solve(A, np.ones(n))
    jx, jits, jh, jte = jax.jit(lambda A_, b_, x0_: jgmres.gmres_solve(
        jp.matvec_with, A_, b_, x0_, restart=10, maxit=60, rtol=1e-12))(
        jp.A, jnp.ones(n, jnp.float64), jnp.zeros(n, jnp.float64))
    tx, tits, th, tte = tgmres.gmres_solve(
        tp.matvec_with, tp.A, torch.ones(n, dtype=torch.float64),
        torch.zeros(n, dtype=torch.float64), restart=10, maxit=60, rtol=1e-12)
    assert tits == int(jits) > 0
    th, jh = th.numpy(), np.asarray(jh)
    assert th.dtype == np.float32 and np.array_equal(th == 0, jh == 0)
    head = _estimates_head(jh)
    assert head >= 3 and _rel(th[:head], jh[:head]) <= 1e-6
    assert np.abs(tx.numpy() - np.asarray(jx)).max() <= 1e-10 * np.abs(ref).max()
    assert np.abs(tx.numpy() - ref).max() <= 1e-8 * np.abs(ref).max()
    assert abs(float(tte) - float(jte)) <= 1e-6 * np.linalg.norm(np.ones(n))


def test_gmres_preconditioned_and_cut_at_maxit():
    """A right preconditioner (Jacobi) in both packages, and a run that stops
    at maxit: its = -maxit, the same estimates."""
    (ip, ix, dv), A = _unsym(40, seed=9)
    n = A.shape[0]
    jp = JPlan(ip, ix, dv, (n, n), dtype="f64", kernel="xla_ell")
    tp = TPlan(ip, ix, dv, (n, n), dtype="f64", kernel="xla_ell", device="cpu")
    dinv = 1.0 / np.diag(A)
    jd, td = jnp.asarray(dinv), torch.as_tensor(dinv)
    for maxit, rtol in ((30, 1e-12), (4, 1e-14)):
        jx, jits, jh, _ = jgmres.gmres_solve(
            jp.matvec_with, jp.A, jnp.ones(n, jnp.float64), jnp.zeros(n, jnp.float64),
            restart=5, maxit=maxit, rtol=rtol, psolve=lambda A_, v: jd * v)
        tx, tits, th, _ = tgmres.gmres_solve(
            tp.matvec_with, tp.A, torch.ones(n, dtype=torch.float64),
            torch.zeros(n, dtype=torch.float64), restart=5, maxit=maxit, rtol=rtol,
            psolve=lambda A_, v: td * v)
        assert tits == int(jits)
        jh = np.asarray(jh)
        head = _estimates_head(jh)
        assert np.array_equal(th.numpy() == 0, jh == 0)
        assert head >= 2 and _rel(th.numpy()[:head], jh[:head]) <= 1e-6
        assert np.abs(tx.numpy() - np.asarray(jx)).max() <= 1e-9 * np.abs(np.asarray(jx)).max()
    # reaching maxit ends the run with its forced solve, counted as a stop
    assert tits == 4


# -- the timed protocol --------------------------------------------------------------


@pytest.fixture
def data_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("LILAC_DATA_DIR", str(tmp_path))
    for k in ("LILAC_SB_TRANSPOSE", "LILAC_HIER_BL", "LILAC_HIER_GMAX"):
        monkeypatch.delenv(k, raising=False)
    return tmp_path


def test_benchmark_mode_matches_reference(data_dir):
    r = tsb.benchmark(10, maxit=20, dtype="f64", device="cpu")
    ref = jsb.benchmark(10, maxit=20, dtype="f64")
    assert r.n == ref.n == 1000 and r.nnz == ref.nnz and r.kernel == ref.kernel
    assert r.iterations == ref.iterations and r.time_s > 0 and r.mflop_rate > 0
    assert r.validated and ref.validated, (r.residual, r.true_residual_rel_gap)
    assert abs(r.residual - ref.residual) <= 1e-6 * ref.residual
    assert r.hist.dtype == np.float32 and r.hist.shape == (20,)
    # sigma relabel (A' = P A P^T) leaves every BiCG scalar invariant
    r2 = tsb.benchmark(10, maxit=20, dtype="f64", sigma_relabel=True, device="cpu")
    assert r2.iterations == r.iterations and r2.nnz == r.nnz and r2.validated
    assert _rel(r2.hist, r.hist) <= 1e-6


@pytest.mark.parametrize("mode", ["adj", "plan"])
@pytest.mark.parametrize("dtype", ["f64", "df64"])
def test_benchmark_routed_single_table(data_dir, monkeypatch, dtype, mode):
    """kernel="routed" (sigma relabel on; K1 and, in adj, K11 through their
    plain versions on the CPU) against the gather run: the same its, the
    first 10 norms to 1e-6, validated; the plan file names the reference's
    key."""
    monkeypatch.setenv("LILAC_SB_TRANSPOSE", mode)
    base = tsb.benchmark(10, maxit=20, dtype="f64", device="cpu")
    r = tsb.benchmark(10, maxit=20, dtype=dtype, kernel="routed", device="cpu")
    assert r.kernel == ("routed_df" if dtype == "df64" else "routed")
    assert (r.plans[1] is None) == (mode == "adj")
    assert r.iterations == base.iterations and r.validated
    assert _rel(r.hist[:10], base.hist[:10]) <= 1e-6
    files = sorted(os.listdir(data_dir))
    assert any(f.startswith("plan_sb10s0r1bl") and "_F_" in f for f in files), files
    assert any("_T_" in f for f in files) == (mode == "plan")


def test_benchmark_routed_hier_forced(data_dir, monkeypatch):
    """One forced hierarchical case (bl = 256): K3-K10 through their plain
    versions, auto = adj, the same trajectory as the gather run."""
    monkeypatch.setenv("LILAC_HIER_BL", "256")
    base = tsb.benchmark(10, maxit=20, dtype="f64", device="cpu")
    r = tsb.benchmark(10, maxit=20, dtype="df64", kernel="routed_hier", device="cpu")
    assert r.kernel == "routed_hier_df" and r.plans[1] is None
    assert r.iterations == base.iterations and r.validated
    assert _rel(r.hist[:10], base.hist[:10]) <= 1e-6
    assert tsb.bench_cache_tag(10, 0, True) == "sb10s0r1bl256ga"


def test_bench_dispatch(monkeypatch):
    """bench run --bench sparsebench: sizes >= 40 run the timed protocol
    through --impl, smaller sizes the golden case (s, size, 2, 0)."""
    calls = []

    class R:
        time_s = 1.5

    monkeypatch.setattr(tsb, "benchmark", lambda size, **kw: calls.append((size, kw)) or R)
    monkeypatch.setattr(tsb, "run_case", lambda *a, **kw: calls.append(a) or R)
    assert tbench.BENCHES["sparsebench"]("160", "routed") == 1.5
    assert tbench.BENCHES["sparsebench"]("10", "auto") == 1.5
    assert calls == [(160, {"kernel": "routed"}), ("s", 10, 2, 0)]
    # bench pathsample: pfold on synthetic_landscape(size, 4 size, seed 0)
    # at the benchmark's T = 0.05 and 10 000 sweeps, as in the JAX package
    from lilac_tpu_torch.workloads import pathsample as tps

    class P:
        time_s = 2.5

    seen = []
    monkeypatch.setattr(tps, "pfold", lambda db, **kw: seen.append((db, kw)) or P)
    assert tbench.BENCHES["pathsample"]("100", "auto") == 2.5
    (db, kw), = seen
    assert kw == {"temperature": 0.05, "npfold": 10000}
    from lilac_tpu.workloads import pathsample as jps

    want = jps.synthetic_landscape(nmin=100, nts=400, seed=0)
    assert db.nmin == 100 and np.array_equal(db.plus, want.plus)
