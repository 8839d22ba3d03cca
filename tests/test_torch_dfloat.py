"""lilac_tpu_torch.ops.dfloat and solvers.algebra against the JAX package.

The same numpy inputs go through both. The JAX ops run op by op (not
jitted), so every EFT step is rounded on its own in both packages and the
(hi, lo) pairs are required to be equal bit for bit; reductions use the
same pairwise tree in both and are held to equality as well.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lilac_tpu.ops import dfloat as jdf
from lilac_tpu.solvers import algebra as jalg
from lilac_tpu_torch.ops import dfloat as tdf
from lilac_tpu_torch.solvers import algebra as talg


def _pair(seed, n=777, spread=6.0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n) * 10.0 ** rng.uniform(-spread, spread, n)


def _both(x64):
    s = jdf.split_f64_np(x64)
    j = jdf.DF(jnp.asarray(s[..., 0]), jnp.asarray(s[..., 1]))
    t = tdf.from_f64(x64, device="cpu")
    return j, t


def _assert_same(j, t):
    np.testing.assert_array_equal(np.asarray(j.hi), t.hi.numpy())
    np.testing.assert_array_equal(np.asarray(j.lo), t.lo.numpy())


def test_split_and_conversions_match():
    x = _pair(0)
    np.testing.assert_array_equal(jdf.split_f64_np(x), tdf.split_f64_np(x))
    j, t = _both(x)
    _assert_same(j, t)
    _assert_same(jdf.from_f64(x), t)
    np.testing.assert_array_equal(jdf.to_f64(j), tdf.to_f64(t))
    # a df64 pair carries ~48 bits
    assert np.abs(tdf.to_f64(t) - x).max() <= 2.0 ** -46 * np.abs(x).max()
    _assert_same(jdf.full((3,), 0.1), tdf.full((3,), 0.1, device="cpu"))
    _assert_same(jdf.zeros((4,)), tdf.zeros((4,), device="cpu"))
    x32 = x.astype(np.float32)
    _assert_same(jdf.from_f32(jnp.asarray(x32)), tdf.from_f32(torch.as_tensor(x32)))


@pytest.mark.parametrize("op", ["add", "sub", "mul", "div"])
def test_binary_ops_bit_identical(op):
    a64, b64 = _pair(1), _pair(2)
    if op in ("add", "sub"):
        # include heavy cancellation: b close to +-a
        b64[:200] = a64[:200] * (1.0 + 1e-9 * np.arange(200))
    ja, ta = _both(a64)
    jb, tb = _both(b64)
    j = getattr(jdf, op)(ja, jb)
    t = getattr(tdf, op)(ta, tb)
    _assert_same(j, t)
    want = {"add": a64 + b64, "sub": a64 - b64, "mul": a64 * b64,
            "div": a64 / b64}[op]
    scale = np.abs(a64) + np.abs(b64) if op in ("add", "sub") else np.abs(want)
    assert (np.abs(tdf.to_f64(t) - want) <= 2.0 ** -44 * scale).all()


def test_sqrt_neg_mul_f32_match():
    a64 = np.abs(_pair(3)) + 1e-30
    ja, ta = _both(a64)
    # sqrt: the Newton correction divides in f32, where the two libraries'
    # CPU kernels may differ by an ulp of the (2^-24 sized) correction:
    # hi equal, value within 2^-46 relative
    js, ts = jdf.sqrt(ja), tdf.sqrt(ta)
    np.testing.assert_array_equal(np.asarray(js.hi), ts.hi.numpy())
    assert (np.abs(jdf.to_f64(js) - tdf.to_f64(ts))
            <= 2.0 ** -46 * np.sqrt(a64)).all()
    _assert_same(jdf.neg(ja), tdf.neg(ta))
    b32 = _pair(4).astype(np.float32)
    _assert_same(jdf.mul_f32(ja, jnp.asarray(b32)),
                 tdf.mul_f32(ta, torch.as_tensor(b32)))
    got = tdf.to_f64(tdf.sqrt(ta))
    assert (np.abs(got - np.sqrt(a64)) <= 2.0 ** -44 * np.sqrt(a64)).all()


@pytest.mark.parametrize("n", [1, 2, 7, 1000, 1400])
def test_reductions_bit_identical(n):
    a64, b64 = _pair(5, n, 2.0), _pair(6, n, 2.0)
    ja, ta = _both(a64)
    jb, tb = _both(b64)
    _assert_same(jdf.sum_df(ja), tdf.sum_df(ta))
    _assert_same(jdf.dot(ja, jb), tdf.dot(ta, tb))
    got = float(tdf.to_f64(tdf.dot(ta, tb)))
    want = float(np.sum(a64.astype(np.longdouble) * b64.astype(np.longdouble)))
    assert abs(got - want) <= 2.0 ** -44 * np.abs(a64 * b64).sum()


def test_sum_axes_bit_identical():
    a64 = _pair(7, 13 * 40, 2.0).reshape(13, 40)
    s = jdf.split_f64_np(a64)
    j = jdf.DF(jnp.asarray(s[..., 0]), jnp.asarray(s[..., 1]))
    t = tdf.from_f64(a64, device="cpu")
    _assert_same(jdf.sum_df(j, axis=1), tdf.sum_df(t, axis=1))
    _assert_same(jdf.sum_df(j, axis=0), tdf.sum_df(t, axis=0))
    _assert_same(jdf.sum_df0(j), tdf.sum_df0(t))


@pytest.mark.parametrize("dtype", ["f32", "f64", "df64"])
def test_algebra_matches(dtype):
    """One CG-shaped chain of algebra calls through both packages."""
    u64, v64 = _pair(8, 300, 1.0), _pair(9, 300, 1.0)
    ja, ta = jalg.get_algebra(dtype), talg.get_algebra(dtype, device="cpu")
    if dtype == "df64":
        (ju, tu), (jv, tv) = _both(u64), _both(v64)
    else:
        npt = {"f32": np.float32, "f64": np.float64}[dtype]
        ju, jv = jnp.asarray(u64.astype(npt)), jnp.asarray(v64.astype(npt))
        tu, tv = torch.as_tensor(u64.astype(npt)), torch.as_tensor(v64.astype(npt))

    def chain(alg, u, v):
        rho = alg.dot(u, u)
        alpha = alg.sdiv(rho, alg.dot(v, v))
        w = alg.sub(alg.add(u, alg.smul(alpha, v)), alg.zeros_like(u))
        nrm = alg.ssqrt(alg.dot(w, w))
        zeta = alg.add(alg.scalar(10.0), alg.sdiv(alg.scalar(1.0), nrm))
        return w, zeta

    jw, jz = chain(ja, ju, jv)
    tw, tz = chain(ta, tu, tv)
    if dtype == "df64":
        # same ops, same tree: equal; zeta passes through sqrt (see above)
        _assert_same(jw, tw)
        jz64, tz64 = float(jdf.to_f64(jz)), float(tdf.to_f64(tz))
        assert abs(jz64 - tz64) <= 2.0 ** -46 * abs(jz64)
        assert ta.to_f64(ta.stack([tz, tz])).shape == (2,)
    else:
        # plain sums are taken in another order by the two libraries
        tol = {"f32": 1e-5, "f64": 1e-13}[dtype]
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=tol, atol=tol)
        np.testing.assert_allclose(float(tz), float(jz), rtol=tol)
        assert ta.to_f64(ta.stack([tz, tz])).dtype == np.float64
