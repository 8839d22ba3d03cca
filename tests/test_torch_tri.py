"""Level-scheduled triangular sweeps (solvers/tri.py) and ILU(0)
(solvers/precond.py) of lilac_tpu_torch against the JAX package's.

Host schedules (level arrays, ILU(0) factors, the Jacobi diagonal) are the
JAX package's bit for bit. The sweeps run the same multiply-adds a row,
summed in another order, so vectors are held to the JAX results to 1e-13
(sweeps) and 1e-12 (ILU(0) solves) relative to max |y|, and to dense
triangular solves.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lilac_tpu.formats.convert import coo_to_csr_arrays
from lilac_tpu.generate import sparsebench_gen as jgen
from lilac_tpu.solvers import precond as jpre
from lilac_tpu.solvers import tri as jtri
from lilac_tpu_torch import convert_reference as cref
from lilac_tpu_torch.generate import sparsebench_gen as tgen
from lilac_tpu_torch.generate.stencil import seven_point_csr
from lilac_tpu_torch.solvers import precond as tpre
from lilac_tpu_torch.solvers import tri as ttri

torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _strict(rng, n, lower=True, density=0.1):
    """A random strictly lower (or upper) triangular CSR and its dense form."""
    rows, cols = np.nonzero(rng.random((n, n)) < density)
    keep = cols < rows if lower else cols > rows
    rows, cols = rows[keep], cols[keep]
    vals = rng.normal(size=len(rows))
    P = coo_to_csr_arrays(rows, cols, vals, (n, n), sum_duplicates=False)
    dense = np.zeros((n, n))
    dense[rows, cols] = vals
    return P, dense


def _parts(name):
    """(CSR, n) triangular parts the SparseBench cases sweep."""
    if name.startswith("regular"):
        _, sym, bj, which = name.split("-")
        _, L, U = tgen.regular_parts(5, sym=sym == "s", bjacobi=bj == "bj")
        return (L if which == "L" else U), 125
    if name.startswith("crs"):
        _, sym, which = name.split("-")
        s = tgen.crs_system(5, sym=sym == "s")
        return s[which], 125
    rng = np.random.default_rng(3)
    P, _ = _strict(rng, 64, lower=name == "random-L")
    return P, 64


PARTS = ["random-L", "random-U", "regular-s-full-L", "regular-u-full-U",
         "regular-u-bj-L", "regular-s-bj-U", "crs-s-L", "crs-u-U"]


@pytest.mark.parametrize("name", PARTS)
def test_level_sweep_arrays_bit_identical(name):
    (ip, ix, dv), n = _parts(name)
    rows, cols, vals = ttri.level_sweep_arrays(ip, ix, dv, n)
    J = jtri.LevelSweep.build(ip, ix, dv, n)
    assert np.array_equal(rows, np.asarray(J.rows))
    assert np.array_equal(cols, np.asarray(J.cols))
    assert np.array_equal(vals, np.asarray(J.vals))
    T = ttri.LevelSweep.build(ip, ix, dv, n, device="cpu")
    assert T.rows.dtype == torch.int64 and T.vals.dtype == torch.float64
    assert np.array_equal(T.cols.numpy(), cols)


@pytest.mark.parametrize("name", PARTS)
def test_sweeps_match_jax(name):
    (ip, ix, dv), n = _parts(name)
    rng = np.random.default_rng(5)
    dinv = 1.0 / rng.uniform(1.0, 2.0, n)
    x = rng.normal(size=n)
    J = jtri.LevelSweep.build(ip, ix, dv, n)
    for T in (ttri.LevelSweep.build(ip, ix, dv, n, device="cpu"),
              cref.level_sweep_from_arrays(n, np.asarray(J.rows), np.asarray(J.cols),
                                           np.asarray(J.vals), device="cpu")):
        got = ttri.sweep_forward(T, _t(dinv), _t(x)).numpy()
        want = np.asarray(jtri.sweep_forward(J, jnp.asarray(dinv), jnp.asarray(x)))
        assert _rel(got, want) <= 1e-13
        got = ttri.sweep_backward(T, _t(dinv), _t(x)).numpy()
        want = np.asarray(jtri.sweep_backward(J, jnp.asarray(dinv), jnp.asarray(x)))
        assert _rel(got, want) <= 1e-13


@pytest.mark.parametrize("lower", [True, False])
def test_levelsweep_matches_dense_solve(lower):
    """Forward / backward sweeps solve the triangular systems exactly."""
    rng = np.random.default_rng(1234)
    n = 64
    d = rng.uniform(1.0, 2.0, n)
    P, dense = _strict(rng, n, lower=lower)
    sweep = ttri.LevelSweep.build(*P, n, device="cpu")
    x = rng.normal(size=n)
    t = ttri.sweep_forward(sweep, _t(1.0 / d), _t(x)).numpy()
    np.testing.assert_allclose(t, np.linalg.solve(dense + np.diag(d), x),
                               rtol=1e-12, atol=1e-12)
    y = ttri.sweep_backward(sweep, _t(1.0 / d), _t(x)).numpy()
    np.testing.assert_allclose(y, np.linalg.solve(np.eye(n) + dense / d[:, None], x),
                               rtol=1e-12, atol=1e-12)


def test_empty_and_cyclic_patterns():
    """No stored entry: no level, the sweep is the diagonal scaling; a
    cycle is refused as in the reference."""
    n = 5
    ip = np.zeros(n + 1, dtype=np.int32)
    T = ttri.LevelSweep.build(ip, np.zeros(0, np.int32), np.zeros(0), n, device="cpu")
    assert T.rows.shape == (0, 1)
    x = np.arange(1.0, n + 1)
    np.testing.assert_array_equal(
        ttri.sweep_forward(T, _t(np.full(n, 0.5)), _t(x)).numpy(), 0.5 * x)
    cyc = coo_to_csr_arrays(np.array([0, 1]), np.array([1, 0]), np.ones(2), (2, 2))
    with pytest.raises(ValueError, match="cyclic"):
        ttri.level_sweep_arrays(*cyc, 2)
    with pytest.raises(ValueError, match="cyclic"):
        jtri.LevelSweep.build(*cyc, 2)


@pytest.mark.parametrize("case", [("s", 1, 2), ("u", 1, 3), ("s", 2, 2), ("u", 2, 2)])
def test_make_ilu_d_matches_jax(case):
    """The ILU-D / block-Jacobi preconditioner of a SparseBench case, built
    by each package from its own generator."""
    from lilac_tpu.workloads import sparsebench as jsb
    from lilac_tpu_torch.workloads import sparsebench as tsb

    sym, structure, prec = case
    _, tpsolve, n, _ = tsb.build_case(sym, 5, structure, prec, device="cpu")
    _, jpsolve, _, _ = jsb.build_case(sym, 5, structure, prec)
    x = np.random.default_rng(11).normal(size=n)
    assert _rel(tpsolve(_t(x)).numpy(), np.asarray(jpsolve(jnp.asarray(x)))) <= 1e-13


# -- ILU(0) ------------------------------------------------------------------


def _ilu_matrices():
    rng = np.random.default_rng(21)
    yield "stencil", seven_point_csr(5, 4, 3)
    n = 60
    M = rng.normal(size=(n, n)) * (rng.random((n, n)) < 0.15)
    A = M + n * np.eye(n)
    r, c = np.nonzero(A)
    yield "unsym", coo_to_csr_arrays(r, c, A[r, c], (n, n)) + ((n, n),)
    ip, ix, dv, shape = jgen.crs_system(5, sym=False)["A"]
    yield "crs", (ip, ix, dv, shape)


ILU_CASES = dict(_ilu_matrices())


@pytest.mark.parametrize("name", sorted(ILU_CASES))
def test_ilu0_host_arrays_bit_identical(name):
    ip, ix, dv, shape = ILU_CASES[name]
    got_v, got_p = tpre.ilu0_factor(ip, ix, dv, shape)
    want_v, want_p = jpre.ilu0_factor(ip, ix, dv, shape)
    assert np.array_equal(got_v, want_v) and np.array_equal(got_p, want_p)
    for lower in (True, False):
        assert np.array_equal(tpre._level_schedule(ip, ix, shape[0], lower),
                              jpre._level_schedule(ip, ix, shape[0], lower))
    T = tpre.ILU0.build(ip, ix, dv, shape, device="cpu")
    J = jpre.ILU0.build(ip, ix, dv, shape)
    for k in ("data", "indices", "row_ids", "diag", "lower_level", "upper_level",
              "lower_level_t", "upper_level_t"):
        assert np.array_equal(getattr(T, k).numpy(), np.asarray(getattr(J, k))), k
    for k in ("n_lower_levels", "n_upper_levels", "n_lower_levels_t", "n_upper_levels_t"):
        assert getattr(T, k) == getattr(J, k), k
    assert np.array_equal(tpre.jacobi_inverse_diagonal(ip, ix, dv, shape),
                          jpre.jacobi_inverse_diagonal(ip, ix, dv, shape))


@pytest.mark.parametrize("name", sorted(ILU_CASES))
def test_ilu0_solves_match_jax(name):
    ip, ix, dv, shape = ILU_CASES[name]
    J = jpre.ILU0.build(ip, ix, dv, shape)
    fields = {k: np.asarray(getattr(J, k)) for k in (
        "data", "indices", "row_ids", "diag", "lower_level", "upper_level",
        "lower_level_t", "upper_level_t")}
    y = np.random.default_rng(23).normal(size=shape[0])
    for T in (tpre.ILU0.build(ip, ix, dv, shape, device="cpu"),
              cref.ilu0_from_arrays(**fields, shape=shape, device="cpu")):
        assert _rel(T.solve(_t(y)).numpy(), np.asarray(J.solve(jnp.asarray(y)))) <= 1e-12
        assert _rel(T.solve_t(_t(y)).numpy(),
                    np.asarray(J.solve_t(jnp.asarray(y)))) <= 1e-12


def test_ilu0_solves_invert_the_factors():
    """solve = (LU)^-1 and solve_t = (LU)^-T, L unit lower and U upper from
    the factor values on A's pattern."""
    ip, ix, dv, shape = ILU_CASES["unsym"]
    n = shape[0]
    vals, _ = tpre.ilu0_factor(ip, ix, dv, shape)
    F = np.zeros(shape)
    F[np.repeat(np.arange(n), np.diff(ip)), ix] = vals
    LU = (np.tril(F, -1) + np.eye(n)) @ np.triu(F)
    T = tpre.ILU0.build(ip, ix, dv, shape, device="cpu")
    y = np.random.default_rng(29).normal(size=n)
    np.testing.assert_allclose(T.solve(_t(y)).numpy(), np.linalg.solve(LU, y),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(T.solve_t(_t(y)).numpy(), np.linalg.solve(LU.T, y),
                               rtol=1e-10, atol=1e-12)


def test_precond_ilu0_improves_cg():
    """ILU(0)-preconditioned CG converges faster than plain CG, on the
    port's seven_point_csr, both to the dense solution."""
    from lilac_tpu.generate.stencil import seven_point_csr as jseven
    from lilac_tpu_torch.plan import SpmvPlan
    from lilac_tpu_torch.solvers.algebra import get_algebra
    from lilac_tpu_torch.solvers.cg import cg_solve

    indptr, indices, data, shape = seven_point_csr(8, 8, 8)
    for got, want in zip((indptr, indices, data), jseven(8, 8, 8)[:3]):
        assert np.array_equal(got, want)
    n = shape[0]
    plan = SpmvPlan(indptr, indices, data, shape, dtype="f64", kernel="xla_ell",
                    device="cpu")
    alg = get_algebra("f64", device="cpu")
    b = torch.ones(n, dtype=torch.float64)
    _, it_plain, _ = cg_solve(plan.matvec_with, alg, plan.A, b, maxit=200, rtol=1e-10)
    fac = tpre.ILU0.build(indptr, indices, data, shape, device="cpu")
    x_pc, it_pc, _ = cg_solve(plan.matvec_with, alg, plan.A, b, maxit=200, rtol=1e-10,
                              precond=lambda A_, r: fac.solve(r))
    assert it_pc < it_plain, (it_pc, it_plain)
    dense = np.zeros(shape)
    dense[np.repeat(np.arange(n), np.diff(indptr)), indices] = data
    np.testing.assert_allclose(x_pc.numpy(), np.linalg.solve(dense, np.ones(n)),
                               rtol=1e-7, atol=1e-8)
