"""PATHSAMPLE in lilac_tpu_torch against the JAX package, on synthetic
landscapes (the reference's LJ38 min.data / ts.data files are not in its
checkout).

* Host arrays (the landscape, the readers, log_rates,
  connectivity_census, branching_matrix, the graph transformation's
  p_ba / p_ab / tau and rates) are the JAX package's bit for bit.
* The sweeps of pfold and tfold run through the port's f64 gather plan and
  agree with the JAX run to 1e-12 relative (atol 1e-13 for pfold's
  committor, whose entries reach 0): the row sums run in another order.
* The oracles of tests/test_pathsample.py hold as they stand.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lilac_tpu.workloads import pathsample as jps
from lilac_tpu_torch import bench as tbench
from lilac_tpu_torch.convert_reference import min_database_from_arrays
from lilac_tpu_torch.workloads import pathsample as ps

torch.set_num_threads(1)

CPU = "cpu"
SWEEP_TOL = dict(rtol=1e-12, atol=1e-13)


@pytest.fixture(scope="module")
def db():
    return ps.synthetic_landscape(nmin=300, nts=1200, seed=3)


def _to_jax(db):
    return jps.MinDatabase(**{f.name: getattr(db, f.name) for f in dataclasses.fields(db)})


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [dict(nmin=300, nts=1200, seed=3), dict(),
                                dict(nmin=50, nts=40, na=2, nb=3, seed=9)])
def test_synthetic_landscape_bit_for_bit(kw):
    got, want = ps.synthetic_landscape(**kw), jps.synthetic_landscape(**kw)
    for f in dataclasses.fields(want):
        _same(getattr(got, f.name), getattr(want, f.name))
    assert (got.nmin, got.nts) == (want.nmin, want.nts)


def test_min_database_from_arrays(db):
    jdb = _to_jax(db)
    got = min_database_from_arrays(**{f.name: np.asarray(getattr(jdb, f.name))
                                      for f in dataclasses.fields(jdb)})
    assert isinstance(got, ps.MinDatabase) and got.emin is not db.emin
    for f in dataclasses.fields(got):
        _same(getattr(got, f.name), getattr(db, f.name))
    with pytest.raises(ValueError, match="fields"):
        min_database_from_arrays(emin=db.emin)


@pytest.mark.parametrize("T", [0.05, 1.0])
def test_log_rates_and_census_bit_for_bit(db, T):
    for g, w in zip(ps.log_rates(db, T), jps.log_rates(_to_jax(db), T)):
        _same(g, w)
    for nconn in (0, 2):
        for g, w in zip(ps.connectivity_census(db, nconn),
                        jps.connectivity_census(_to_jax(db), nconn)):
            _same(g, w)


@pytest.mark.parametrize("direction, T, nconn, block", [
    ("AB", 0.05, 0, True), ("BA", 0.05, 0, True), ("AB", 1.2, 0, False),
    ("BA", 0.8, 2, True)])
def test_branching_matrix_bit_for_bit(db, direction, T, nconn, block):
    kw = dict(temperature=T, direction=direction, nconnmin=nconn, block_opposite=block)
    for g, w in zip(ps.branching_matrix(db, **kw), jps.branching_matrix(_to_jax(db), **kw)):
        _same(g, w)


def test_branching_matrix_is_stochastic(db):
    indptr, indices, data, has_row, sink = ps.branching_matrix(
        db, temperature=0.05, direction="AB")
    n = db.nmin
    rowsum = np.zeros(n)
    np.add.at(rowsum, np.repeat(np.arange(n), np.diff(indptr)), data)
    assert (data > 0).all()
    assert rowsum[has_row].max() <= 1.0 + 1e-12
    assert not has_row[np.nonzero(sink)[0]].any()


@pytest.mark.parametrize("direction", ["AB", "BA"])
def test_committor_matches_dense_solution(db, direction):
    """At a mixing temperature 4000 sweeps come within 1e-3 of the dense
    fixed point, and the run is the JAX package's to 1e-12."""
    ref = ps.dense_committor(db, temperature=1.0, direction=direction)
    np.testing.assert_array_equal(
        ref, jps.dense_committor(_to_jax(db), temperature=1.0, direction=direction))
    r = ps.pfold(db, temperature=1.0, direction=direction, npfold=4000, device=CPU)
    assert np.abs(r.committor - ref).max() < 1e-3
    assert 0.0 <= r.committor.min() and r.committor.max() <= 1.0 + 1e-12
    want = jps.pfold(_to_jax(db), temperature=1.0, direction=direction, npfold=4000)
    np.testing.assert_allclose(r.committor, want.committor, **SWEEP_TOL)
    assert (r.npfold, r.nmin, r.nnz) == (want.npfold, want.nmin, want.nnz)
    np.testing.assert_allclose(r.residual, want.residual, rtol=1e-6, atol=1e-15)


def test_device_sweeps_match_host_exactly(db):
    """q <- D q with empty rows skipped (spmv.f90:14-21), 137 sweeps, held
    to a host loop (tests/test_pathsample.py's) and to the JAX run."""
    indptr, indices, data, has_row, sink = ps.branching_matrix(
        db, temperature=0.05, direction="AB")
    n = db.nmin
    q = np.zeros(n)
    q[np.nonzero(sink)[0]] = 1.0
    rows = np.repeat(np.arange(n), np.diff(indptr))
    for _ in range(137):
        y = np.zeros(n)
        np.add.at(y, rows, data * q[indices])
        q = np.where(has_row, y, q)
    r = ps.pfold(db, temperature=0.05, direction="AB", npfold=137, device=CPU)
    np.testing.assert_allclose(r.committor, q, **SWEEP_TOL)
    want = jps.pfold(_to_jax(db), temperature=0.05, direction="AB", npfold=137)
    np.testing.assert_allclose(r.committor, want.committor, **SWEEP_TOL)
    assert r.time_s > 0 and np.isfinite(r.residual)


def test_pfold_seeded_q0(db):
    q0 = np.random.default_rng(4).random(db.nmin)
    r = ps.pfold(db, temperature=0.3, npfold=50, q0=q0, device=CPU)
    want = jps.pfold(_to_jax(db), temperature=0.3, npfold=50, q0=q0)
    np.testing.assert_allclose(r.committor, want.committor, **SWEEP_TOL)


def test_committor_boundary_values(db):
    r = ps.pfold(db, temperature=0.05, direction="AB", npfold=2000, device=CPU)
    np.testing.assert_allclose(r.committor[db.a_set], 1.0)
    assert r.committor[db.b_set].min() >= 0.0


def test_pathdata_parser(tmp_path):
    p = tmp_path / "pathdata"
    p.write_text(
        "NATOMS 38\nSEED 1\n\n! a comment\nCYCLES 0\nNCONNMIN 3\n"
        "PFOLD 10000 1 0.5\nTEMPERATURE 0.01D0\nDIRECTION BA\n")
    cfg = ps.read_pathdata(str(p))
    assert cfg == jps.read_pathdata(str(p))
    assert cfg == dict(nconnmin=3, temperature=0.01, direction="BA", npfold=10000,
                       omega=0.5)


def _write_database(d, db):
    with open(d / "min.data", "w") as f:
        for e, fv, h in zip(db.emin, db.fvib, db.horder):
            f.write(f"{float(e)!r} {float(fv)!r} {h} 1.0 0.0 0.0\n")
    with open(d / "ts.data", "w") as f:
        for e, fv, h, p, m in zip(db.ets, db.fvibts, db.hordts, db.plus, db.minus):
            f.write(f"{float(e)!r} {float(fv)!r} {h} {p + 1} {m + 1} 0.0 0.0 1.0\n")
    for name, s in (("min.A", db.a_set), ("min.B", db.b_set)):
        (d / name).write_text(f"{len(s)}\n" + "\n".join(str(i + 1) for i in s) + "\n")


def test_min_data_roundtrip(tmp_path):
    mind = tmp_path / "min.data"
    mind.write_text("-173.9 301.2 2 1 0 0\n-172.1 299.0 1 0 1 0\n")
    e, f, h = ps.read_min_data(str(mind))
    assert e.tolist() == [-173.9, -172.1] and h.tolist() == [2, 1]
    seta = tmp_path / "min.A"
    seta.write_text("2\n1 2\n")
    assert ps.read_min_set(str(seta)).tolist() == [0, 1]


def test_load_database_matches_reference(tmp_path):
    """A database written to disk loads to the landscape it came from, and
    to the JAX package's arrays."""
    src = ps.synthetic_landscape(nmin=60, nts=150, seed=2)
    _write_database(tmp_path, src)
    got = ps.load_database(str(tmp_path))
    want = jps.load_database(str(tmp_path))
    for f in dataclasses.fields(got):
        _same(getattr(got, f.name), getattr(want, f.name))
        _same(getattr(got, f.name), getattr(src, f.name))
    for g, w in zip(ps.read_ts_data(str(tmp_path / "ts.data")),
                    jps.read_ts_data(str(tmp_path / "ts.data"))):
        _same(g, w)


@pytest.fixture(scope="module")
def ngt_pair(db):
    return ps.ngt(db, temperature=0.8, device=CPU), jps.ngt(_to_jax(db), temperature=0.8)


def test_ngt_host_arrays_bit_for_bit(db, ngt_pair):
    r, want = ngt_pair
    for name in ("p_ba", "p_ab", "tau"):
        _same(getattr(r, name), getattr(want, name))
    for name in ("kAB", "kBA", "kSSAB", "kSSBA", "detailed_balance", "detailed_balance_nss"):
        assert getattr(r, name) == getattr(want, name)
    assert r.committor is None
    P, tau, lnconn = ps._branching_full(db, 0.8, 0)
    jP, jtau, jlnconn = jps._branching_full(_to_jax(db), 0.8, 0)
    assert P == jP
    _same(tau, jtau)
    _same(lnconn, jlnconn)


def test_ngt_gt_preserves_committor_and_mfpt(db, ngt_pair):
    """GT renormalisation is exact: the reduced network's branching sums
    equal dense first-passage probabilities, and renormalised waiting
    times dense mean first-passage times to A∪B."""
    r, _ = ngt_pair
    P, tau0, _ = ps._branching_full(db, 0.8, 0)
    n = db.nmin
    D = np.zeros((n, n))
    for i, row in enumerate(P):
        for j, v in row.items():
            D[i, j] = v
    ab = np.zeros(n, dtype=bool)
    ab[db.a_set] = True
    ab[db.b_set] = True
    inter = ~ab
    in_b = np.zeros(n, dtype=bool)
    in_b[db.b_set] = True
    PII = D[np.ix_(inter, inter)]
    h = np.linalg.solve(np.eye(inter.sum()) - PII, D[np.ix_(inter, in_b)].sum(axis=1))
    hfull = np.zeros(n)
    hfull[inter] = h
    hfull[db.b_set] = 1.0
    for i, a in enumerate(db.a_set):
        assert abs(r.p_ba[i] - float(D[a] @ hfull)) < 1e-10
    t = np.linalg.solve(np.eye(inter.sum()) - PII, tau0[inter])
    tfull = np.zeros(n)
    tfull[inter] = t
    for a in db.a_set:
        expect = tau0[a] + float(D[a] @ tfull)
        assert abs(r.tau[a] - expect) < 1e-9 * max(1.0, expect)


def test_ngt_detailed_balance(ngt_pair):
    r, _ = ngt_pair
    assert abs(r.detailed_balance - 1.0) < 1e-10, r.detailed_balance
    assert r.kAB > 0 and r.kBA > 0 and np.isfinite(r.detailed_balance_nss)


@pytest.mark.parametrize("direction", ["BA", "AB"])
def test_ngt_seeded_pfold(db, direction):
    r = ps.ngt(db, temperature=0.8, npfold=200, direction=direction, device=CPU)
    assert 0.0 <= r.committor.min() and r.committor.max() <= 1.0 + 1e-9
    want = jps.ngt(_to_jax(db), temperature=0.8, npfold=200, direction=direction)
    np.testing.assert_allclose(r.committor, want.committor, **SWEEP_TOL)


def test_write_commit_data(tmp_path):
    q = np.random.default_rng(8).random(20)
    ps.write_commit_data(str(tmp_path / "a"), q)
    jps.write_commit_data(str(tmp_path / "b"), q)
    assert (tmp_path / "a").read_text() == (tmp_path / "b").read_text()
    assert len((tmp_path / "a").read_text().splitlines()) == 20


def test_tfold_matches_dense_mfpt_and_reference(db):
    """Jacobi MFPT sweeps converge to the dense first-step solution, and
    equal the JAX run to 1e-12."""
    T = 1.2
    r = ps.tfold(db, temperature=T, direction="AB", ntfold=40000, device=CPU)
    indptr, indices, data, has_row, sink = ps.branching_matrix(
        db, temperature=T, direction="AB", block_opposite=False)
    n = db.nmin
    D = np.zeros((n, n))
    D[np.repeat(np.arange(n), np.diff(indptr)), indices] = data
    kplus, kminus = ps.log_rates(db, T)
    lksum = np.zeros(n)
    live = db.plus != db.minus
    np.add.at(lksum, db.plus[live], np.exp(kplus[live]))
    np.add.at(lksum, db.minus[live], np.exp(kminus[live]))
    tau = np.where(lksum > 0, 1.0 / lksum, 0.0)
    tau[np.asarray(sink)] = 0.0
    free = has_row & ~sink
    t_ref = np.zeros(n)
    t_ref[free] = np.linalg.solve(np.eye(free.sum()) - D[np.ix_(free, free)], tau[free])
    err = np.abs(r.mfpt - t_ref) / np.maximum(1.0, np.abs(t_ref))
    assert err.max() < 1e-10, err.max()
    assert r.kAB > 0 and r.iterations == 40000
    want = jps.tfold(_to_jax(db), temperature=T, direction="AB", ntfold=40000)
    np.testing.assert_allclose(r.mfpt, want.mfpt, rtol=1e-12)
    np.testing.assert_allclose(r.kAB, want.kAB, rtol=1e-12)


def test_tfold_short_run_matches_reference(db):
    """A few sweeps at the benchmark's temperature, BA, far from the fixed
    point: every sweep's rounding counts."""
    r = ps.tfold(db, temperature=0.05, direction="BA", ntfold=300, device=CPU)
    want = jps.tfold(_to_jax(db), temperature=0.05, direction="BA", ntfold=300)
    np.testing.assert_allclose(r.mfpt, want.mfpt, rtol=1e-12)
    np.testing.assert_allclose(r.kAB, want.kAB, rtol=1e-12)


def test_bench_pathsample_runs(monkeypatch):
    """bench run --bench pathsample on the CPU: pfold on a landscape of
    `size` minima, 10 000 sweeps."""
    import functools

    monkeypatch.setattr(ps, "pfold", functools.partial(ps.pfold, device=CPU))
    row = tbench.run_bench("pathsample", "40", runs=1, platform="cpu")
    assert row.csv()[:4] == ["cpu", "pathsample", "auto", "40"] and row.times[0] > 0
