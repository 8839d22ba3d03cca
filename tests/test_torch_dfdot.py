"""lilac_tpu_torch.kernels.dfdot: the df64 dot of the solvers in two launches.

The kernel's schedule (each thread's subtree of the halving tree to level
K, then the tree on the n_K values) runs here as dfdot_plain, in eager f32
ops, and is held to df.dot bit for bit at odd and even sizes, at several K,
on inputs spread over 12 decades with cancelling signs and on planes of
signed zeros, subnormals and wide exponents, and to the JAX package's dot.
CPU planes never reach the CUDA library, and DF64Alg.dot on the CPU is still
the JAX package's dot bit for bit. The kernel itself, and the library's
choice of K, are held to df.dot on a card in test_torch_dfdot_card.py.
DF64Alg.sdiv takes a zero numerator to that zero, where the JAX package's
df.div gives 0/0 = NaN, so that NPB's CG, whose rho underflows f32's
exponent range once it has converged, stays finite; every other quotient is
the JAX divide's bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lilac_tpu.ops import dfloat as jdf
from lilac_tpu_torch.kernels import _cuda
from lilac_tpu_torch.kernels import dfdot as kd
from lilac_tpu_torch.ops import dfloat as tdf
from lilac_tpu_torch.solvers import algebra as talg

SIZES = (1, 2, 3, 5, 4097, 9375, 150000, 150001)


def _planes(n, seed):
    """Two df vectors of n terms spread over 12 decades, a third of the
    products cancelling a neighbour's to 1e-9."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(n) * 10.0 ** rng.uniform(-6, 6, n)
    b = rng.standard_normal(n) * 10.0 ** rng.uniform(-6, 6, n)
    k = (n // 3) * 2
    a[1:k:2] = -a[0:k:2] * (1.0 + 1e-9)
    b[1:k:2] = b[0:k:2]
    return a, b


def _bits(d):
    return (d.hi.view(torch.int32).tolist(), d.lo.view(torch.int32).tolist())


def _df(x):
    return tdf.from_f64(x, device="cpu")


def _jdf(d):
    """The same planes as a JAX df value."""
    return jdf.DF(jnp.asarray(d.hi.numpy()), jnp.asarray(d.lo.numpy()))


def _jbits(d):
    return (np.asarray(d.hi).view(np.int32).tolist(),
            np.asarray(d.lo).view(np.int32).tolist())


@pytest.mark.parametrize("K", [0, 1, 3, 5, 7])
@pytest.mark.parametrize("n", SIZES)
def test_plain_schedule_is_df_dot_bit_for_bit(n, K):
    a, b = _planes(n, n + K)
    u, v = _df(a), _df(b)
    got = kd.dfdot_plain(u, v, K)
    assert got.hi.shape == () and got.hi.dtype == torch.float32
    assert _bits(got) == _bits(tdf.dot(u, v))
    assert _bits(got) == _jbits(jdf.dot(_jdf(u), _jdf(v)))


@pytest.mark.parametrize("n", [7, 4097, 150001])
def test_plain_schedule_keeps_signed_zeros_and_subnormals(n):
    """Planes of +0, -0, subnormals and values near f32's range ends: the
    pads are added df zeros, as F.pad's are."""
    rng = np.random.default_rng(n)
    pick = rng.integers(0, 5, n)
    vals = np.array([0.0, -0.0, 1e-40, -3e-39, 1e30])
    a = vals[pick] * np.where(pick == 4, rng.uniform(0.5, 2.0, n), 1.0)
    b = np.where(rng.random(n) < 0.5, -1.0, 1.0) * 10.0 ** rng.uniform(-8, 4, n)
    for u, v in ((_df(a), _df(b)), (_df(-np.abs(a) * 0.0), _df(b))):
        want = _bits(tdf.dot(u, v))
        for K in (1, 4, 5):
            assert _bits(kd.dfdot_plain(u, v, K)) == want


@pytest.mark.parametrize("n", [1, 9375, 150000])
def test_cpu_planes_never_touch_the_cuda_library(monkeypatch, n):
    """DF64Alg.dot takes the op chain on CPU tensors, and dfdot refuses
    them: no build, no library load, no launch count."""
    def boom(*a, **k):
        raise AssertionError("CUDA library touched for a CPU tensor")

    monkeypatch.setattr(_cuda, "load", boom)
    monkeypatch.setattr(_cuda, "build_all", boom)
    before = kd.dfdot.launches
    a, b = _planes(n, 7)
    u, v = _df(a), _df(b)
    want = _bits(tdf.dot(u, v))
    assert _bits(talg.DF64Alg(device="cpu").dot(u, v)) == want
    with pytest.raises(ValueError, match="CUDA"):
        kd.dfdot(u, v)
    assert kd.dfdot.launches == before


@pytest.mark.parametrize("n", [1, 5, 4097, 150001])
def test_df64alg_dot_on_the_cpu_is_the_jax_dot(n):
    a, b = _planes(n, 3 * n)
    sa, sb = jdf.split_f64_np(a), jdf.split_f64_np(b)
    j = jdf.dot(jdf.DF(jnp.asarray(sa[..., 0]), jnp.asarray(sa[..., 1])),
                jdf.DF(jnp.asarray(sb[..., 0]), jnp.asarray(sb[..., 1])))
    t = talg.DF64Alg(device="cpu").dot(_df(a), _df(b))
    np.testing.assert_array_equal(np.asarray(j.hi), t.hi.numpy())
    np.testing.assert_array_equal(np.asarray(j.lo), t.lo.numpy())
    # and the value is the dot to df64's grade
    exact = (a.astype(np.longdouble) * b.astype(np.longdouble)).sum()
    mag = float(np.abs(a * b).sum())
    assert abs(tdf.to_f64(t) - float(exact)) <= 2.0 ** -44 * mag


def test_dfdot_refuses_planes_it_does_not_take():
    a = torch.ones(8)
    z = torch.zeros(8)
    for bad in ((a, z, a[:7], z[:7]), (a, z, a.double(), z.double()),
                (a.view(2, 4), z.view(2, 4), a.view(2, 4), z.view(2, 4)),
                (a[:0], z[:0], a[:0], z[:0])):
        with pytest.raises(ValueError):
            kd.dfdot(tdf.DF(*bad[:2]), tdf.DF(*bad[2:]))
    # planes it would take on a card: the op chain is the dot on the CPU
    w = torch.arange(16, dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        kd.dfdot(tdf.DF(w[::2], torch.zeros(8)), tdf.DF(a, z))


def test_df64_scalar_divide_of_zero_is_zero():
    """A zero numerator gives that zero where df.div gives 0/0 = NaN, and every
    other quotient keeps df.div's bits: a converged CG's rho underflows
    f32's exponent range, which a df64 word keeps."""
    alg = talg.DF64Alg(device="cpu")
    scalar = lambda v: tdf.full((), v, device="cpu")  # noqa: E731
    zero, tiny = scalar(0.0), scalar(-3e-40)
    assert torch.isnan(tdf.div(zero, zero).hi)
    for b in (zero, tiny, scalar(2.5)):
        assert _bits(alg.sdiv(zero, b)) == (0, 0)
        assert _bits(alg.sdiv(tdf.neg(zero), b)) == _bits(tdf.neg(zero))
    a, b = _planes(64, 5)
    for x, y in zip(a, b):
        u, v = scalar(x), scalar(y)
        assert _bits(alg.sdiv(u, v)) == _bits(tdf.div(u, v))


def test_df64_scalar_divide_is_the_jax_divide_but_at_a_zero_numerator():
    """Against the JAX package's df.div: the same bits for every nonzero
    numerator (in f32's normal range: XLA on the CPU flushes subnormals,
    torch keeps them); at 0/0 the JAX divide gives NaN and the port that
    zero, the one place the guard makes them part."""
    alg = talg.DF64Alg(device="cpu")
    scalar = lambda v: tdf.full((), v, device="cpu")  # noqa: E731
    a, b = _planes(64, 11)
    pairs = list(zip(a, b)) + [(1e19, 1e-18), (-1e-30, 3e7), (1.0 / 3.0, 3.0),
                               (-0.1, -0.1), (2.0 ** -100, -(2.0 ** 20))]
    for x, y in pairs:
        u, v = scalar(x), scalar(y)
        assert _bits(alg.sdiv(u, v)) == _jbits(jdf.div(_jdf(u), _jdf(v)))
    zero = scalar(0.0)
    for num in (zero, tdf.neg(zero)):
        j = jdf.div(_jdf(num), _jdf(zero))
        assert np.isnan(np.asarray(j.hi))
        got = alg.sdiv(num, zero)
        assert _bits(got) == _bits(tdf.DF(num.hi, num.hi))


def test_npb_cg_from_an_eigenvector_stays_finite():
    """NPB's CG from an eigenvector of tridiag(-1, 4, -1): its recurrence
    residual leaves f32's exponent range within the 25 iterations (rho
    reaches 0), and z stays the solution instead of going NaN."""
    from lilac_tpu_torch.solvers.cg import npb_conj_grad

    n = 64
    j = np.arange(1, n + 1)
    lam = 4.0 - 2.0 * np.cos(3 * np.pi / (n + 1))
    x = np.sin(3 * j * np.pi / (n + 1))
    x /= np.linalg.norm(x)
    four = tdf.full((), 4.0, device="cpu")

    def shift(p, k):
        z = torch.zeros(1, dtype=torch.float32)
        h, l_ = (torch.cat([z, t[:-1]]) if k > 0 else torch.cat([t[1:], z]) for t in p)
        return tdf.DF(h, l_)

    def matvec(A, p):
        return tdf.sub(tdf.sub(tdf.mul(four, p), shift(p, 1)), shift(p, -1))

    alg = talg.DF64Alg(device="cpu")
    rhos = []
    dot = alg.dot
    alg.dot = lambda u, v: rhos.append(dot(u, v)) or rhos[-1]
    z, rnorm = npb_conj_grad(matvec, alg, None, _df(x))
    assert any(r.hi.item() == 0.0 for r in rhos)  # the residual underflowed
    zf = tdf.to_f64(z)
    assert np.isfinite(zf).all() and np.isfinite(tdf.to_f64(rnorm))
    assert np.abs(zf - x / lam).max() <= 1e-13
