"""Line-ILU (SparseBench precond 4) of lilac_tpu_torch against the JAX
package's and the loop-level oracle.

Host arrays (the wavefront schedule, the transposed bands, the oracle) are
the JAX package's bit for bit. The device apply runs its affine recurrences
as a doubling scan where the JAX package runs `lax.associative_scan`; the
two trees round in different places, so applies are held to the JAX apply
and to the oracle to 1e-12 relative (of max |y|).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lilac_tpu.generate import sparsebench_gen as jgen
from lilac_tpu.solvers import line_ilu as jli
from lilac_tpu_torch import convert_reference as cref
from lilac_tpu_torch.generate import sparsebench_gen as tgen
from lilac_tpu_torch.solvers import line_ilu as tli
from lilac_tpu_torch.workloads import sparsebench as tsb

torch.set_num_threads(1)

REL = 1e-12


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _random_bands(rng, n1, n2, n3):
    """Band arrays of a nonsymmetric 7-point operator on an n1 x n2 x n3
    grid, neighbours outside the grid zeroed."""
    bands = {0: 6.0 + rng.random((n1, n2, n3))}
    for p, ax in ((1, 0), (2, 1), (3, 2)):
        b = rng.normal(size=(n1, n2, n3))
        e = rng.normal(size=(n1, n2, n3))
        hi = [slice(None)] * 3
        hi[ax] = slice(-1, None)
        b[tuple(hi)] = 0.0
        lo = [slice(None)] * 3
        lo[ax] = slice(0, 1)
        e[tuple(lo)] = 0.0
        bands[p] = b
        bands[-p] = e
    return bands


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n", [1, 2, 7, 11, 16, 33])
def test_affine_scan_matches_loop_and_jax(n, reverse):
    rng = np.random.default_rng(3 + n)
    A = rng.normal(size=(3, n))
    B = rng.normal(size=(3, n))
    want = np.zeros_like(A)
    prev = np.zeros(3)
    for i in (range(n - 1, -1, -1) if reverse else range(n)):
        prev = A[:, i] * prev + B[:, i]
        want[:, i] = prev
    got = tli._affine_scan(_t(A), _t(B), reverse=reverse).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-14)
    ref = np.asarray(jli._affine_scan(jnp.asarray(A), jnp.asarray(B), reverse=reverse))
    np.testing.assert_allclose(got, ref, rtol=1e-13, atol=1e-14)


def test_line_ssor_solve_is_tridiagonal_ssor():
    """One line and a batch of lines against dense solves and the JAX
    solve."""
    rng = np.random.default_rng(5)
    n = 16
    d = 4.0 + rng.random((3, n))
    am1 = np.concatenate([np.zeros((3, 1)), rng.normal(size=(3, n - 1))], axis=1)
    ap1 = np.concatenate([rng.normal(size=(3, n - 1)), np.zeros((3, 1))], axis=1)
    x = rng.normal(size=(3, n))
    got = tli.line_ssor_solve(_t(1.0 / d), _t(am1), _t(ap1), _t(x)).numpy()
    for b in range(3):
        D = np.diag(d[b])
        L = np.diag(am1[b, 1:], -1)
        U = np.diag(ap1[b, :-1], 1)
        want = np.linalg.solve(np.eye(n) + np.linalg.solve(D, U),
                               np.linalg.solve(D + L, x[b]))
        np.testing.assert_allclose(got[b], want, rtol=1e-12, atol=1e-13)
    ref = np.asarray(jli.line_ssor_solve(jnp.asarray(1.0 / d), jnp.asarray(am1),
                                         jnp.asarray(ap1), jnp.asarray(x)))
    assert _rel(got, ref) <= REL


@pytest.mark.parametrize("n2,n3", [(1, 1), (4, 4), (5, 3), (2, 7)])
def test_wavefront_bit_identical(n2, n3):
    for got, want in zip(tli._wavefront(n2, n3), jli._wavefront(n2, n3)):
        assert got.dtype == np.int64 and np.array_equal(got, want)


@pytest.mark.parametrize("sym", [True, False])
def test_transpose_bands_and_oracle_bit_identical(sym):
    bands = tgen.regular_system(4, sym)["bands"]
    got, want = tli._transpose_bands(bands), jli._transpose_bands(bands)
    assert sorted(got) == sorted(want)
    for p in got:
        assert np.array_equal(got[p], want[p]), p
    x = np.random.default_rng(9).normal(size=4**3)
    assert np.array_equal(tli.reference_line_ilusolve(bands, x),
                          jli.reference_line_ilusolve(bands, x))


@pytest.mark.parametrize("size", [4, 5, 10])
@pytest.mark.parametrize("sym", [True, False])
def test_apply_matches_jax_and_oracle(sym, size):
    bands = tgen.regular_system(size, sym)["bands"]
    x = np.random.default_rng(7 + size).normal(size=size**3)
    want = tli.reference_line_ilusolve(bands, x)
    got = tli.LineILU.build(bands, device="cpu").apply(_t(x)).numpy()
    assert _rel(got, want) <= REL
    ref = np.asarray(jli.LineILU.build(bands).apply(jnp.asarray(x)))
    assert _rel(got, ref) <= REL


@pytest.mark.parametrize("sym", [True, False])
def test_transpose_apply_matches_dense_transpose_and_jax(sym):
    bands = tgen.regular_system(4, sym)["bands"]
    n = 4**3
    Minv = np.stack([tli.reference_line_ilusolve(bands, e) for e in np.eye(n)], axis=1)
    x = np.random.default_rng(11).normal(size=n)
    psolve, psolve_t = tli.make_line_ilu(bands, device="cpu")
    got = psolve_t(_t(x)).numpy()
    np.testing.assert_allclose(got, Minv.T @ x, rtol=1e-10, atol=1e-12)
    ref = np.asarray(jli.LineILU.build(bands, transpose=True).apply(jnp.asarray(x)))
    assert _rel(got, ref) <= REL
    np.testing.assert_allclose(psolve(_t(x)).numpy(), Minv @ x, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("shape", [(6, 4, 3), (3, 5, 2), (8, 1, 6)])
def test_rectangular_grid(shape):
    """Wavefront schedule on n2 != n3 grids (beyond the reference's cubes)."""
    rng = np.random.default_rng(13)
    bands = _random_bands(rng, *shape)
    x = rng.normal(size=int(np.prod(shape)))
    got = tli.LineILU.build(bands, device="cpu").apply(_t(x)).numpy()
    assert _rel(got, tli.reference_line_ilusolve(bands, x)) <= REL
    ref = np.asarray(jli.LineILU.build(bands).apply(jnp.asarray(x)))
    assert _rel(got, ref) <= REL


@pytest.mark.parametrize("transpose", [False, True])
def test_line_ilu_from_jax_fields_equals_port_build(transpose):
    """The JAX package's LineILU fields, handed over as numpy arrays, give the
    port's own build: every field bit for bit, so the same apply."""
    bands = _random_bands(np.random.default_rng(17), 5, 4, 3)
    J = jli.LineILU.build(bands, transpose=transpose)
    names = cref.LINE_ILU_PLANES + cref.LINE_ILU_SCHEDULE
    M = cref.line_ilu_from_arrays(J.n1, J.n2, J.n3, device="cpu",
                                  **{k: np.asarray(getattr(J, k)) for k in names})
    T = tli.LineILU.build(bands, transpose=transpose, device="cpu")
    for k in names:
        assert torch.equal(getattr(M, k), getattr(T, k)), k
    x = _t(np.random.default_rng(19).normal(size=60))
    assert torch.equal(M.apply(x), T.apply(x))


def test_precond4_beats_bjacobi_on_gmres_case():
    """u/10/1 at the validated maxit=10: golden residuals are 12.73 (none)
    and 3.89 (block-Jacobi); line-ILU lands well below both, and where the
    JAX package's run lands: the same iterations, the residual to 1e-8
    relative (the two packages' f64 sums round in another order, and ten
    GMRES steps take the residual from 31.6 down to 0.05)."""
    from lilac_tpu.workloads.sparsebench import run_case

    base = tsb.run_case("u", 10, 1, 0, device="cpu")
    lilu = tsb.run_case("u", 10, 1, 4, device="cpu")
    assert lilu.residual < 0.1 * base.residual
    assert lilu.residual < 1.0
    ref = run_case("u", 10, 1, 4)
    assert lilu.iterations == ref.iterations
    assert abs(lilu.residual - ref.residual) <= 1e-8 * ref.residual


def test_bands_bit_identical_to_jax_generator():
    for sym in (True, False):
        got = tgen.regular_system(5, sym)["bands"]
        want = jgen.regular_system(5, sym)["bands"]
        for p in want:
            assert np.array_equal(got[p], want[p]), (sym, p)
