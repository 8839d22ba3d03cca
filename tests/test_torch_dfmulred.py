"""lilac_tpu_torch.kernels.dfmulred against the JAX package's fused kernel.

The plain version repeats the Pallas kernel's loop (dot2) step for step,
so its high word equals the interpret-mode kernel's. The low words differ
in their last bits in about a fifth of the rows: XLA:CPU compiles the
interpreted kernel body as one fusion, and each version is as close to the
exact sum as the other (about 2e-14 of the sum of magnitudes, the df64
grade). The two are therefore held to 4e-14 * sum|v*x|, not to a bound
relative to the result, which cancellation makes arbitrarily small.
Against the op chain (another summation tree) the agreement is 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lilac_tpu.kernels import dfmulred as jdk
from lilac_tpu.ops import dfloat as jdf
from lilac_tpu_torch.kernels import _cuda
from lilac_tpu_torch.kernels import dfmulred as tdk
from lilac_tpu_torch.ops import dfloat as tdf


def _planes(seed, K, R):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((K, R)) * 10.0 ** rng.uniform(-6, 6)
    x = rng.standard_normal((K, R)) * 10.0 ** rng.uniform(-6, 6)
    return v, x, tdf.split_f64_np(v), tdf.split_f64_np(x)


def _val(h, l_):
    return np.asarray(h, np.float64) + np.asarray(l_, np.float64)


@pytest.mark.parametrize("K,R", [(1, 300), (7, 513), (16, 1024), (35, 200)])
def test_dfmulred_plain_matches_f64_oracle(K, R):
    v, x, vs, xs = _planes(K, K, R)
    args = [torch.as_tensor(np.ascontiguousarray(a))
            for a in (vs[..., 0], vs[..., 1], xs[..., 0], xs[..., 1])]
    yh, yl = tdk.dfmulred(*args)  # CPU tensors: the plain version
    assert yh.shape == (R,) and yh.dtype == torch.float32
    prod = v.astype(np.longdouble) * x.astype(np.longdouble)
    want = prod.sum(axis=0).astype(np.float64)
    # dot2 error is O(K^2 eps32^2 sum|terms|), eps32^2 = 3.6e-15
    bound = 1e-11 * np.abs(prod).sum(axis=0).astype(np.float64) + 1e-30
    assert (np.abs(_val(yh.numpy(), yl.numpy()) - want) <= bound).all()


@pytest.mark.parametrize("K,R", [(5, 1024), (27, 1024)])
def test_dfmulred_plain_matches_pallas_interpret(K, R):
    v, x, vs, xs = _planes(100 + K, K, R)
    planes = (vs[..., 0], vs[..., 1], xs[..., 0], xs[..., 1])
    jh, jl = jdk.dfmulred(*[jnp.asarray(a) for a in planes], R, interpret=True)
    th, tl = tdk.dfmulred_plain(*[torch.as_tensor(np.ascontiguousarray(a)) for a in planes])
    np.testing.assert_array_equal(np.asarray(jh), th.numpy())
    a, b = _val(jh, jl), _val(th.numpy(), tl.numpy())
    mag = np.abs(v * x).sum(axis=0)
    exact = (v.astype(np.longdouble) * x.astype(np.longdouble)).sum(axis=0)
    assert (np.abs(a - b) <= 4e-14 * mag).all()
    assert (np.abs(b - exact.astype(np.float64)) <= 4e-14 * mag).all()


def test_chunk_mulreduce_matches_reference_fused_and_chain():
    chlist = ((0, 400, 5), (2000, 100, 13))
    m = 4096
    rng = np.random.default_rng(42)
    vals64, o64 = rng.standard_normal(m), rng.standard_normal(m)
    vs, os_ = tdf.split_f64_np(vals64), tdf.split_f64_np(o64)
    jv, joh, jol = jnp.asarray(vs), jnp.asarray(os_[..., 0]), jnp.asarray(os_[..., 1])
    tv = torch.as_tensor(vs)
    toh = torch.as_tensor(np.ascontiguousarray(os_[..., 0]))
    tol_ = torch.as_tensor(np.ascontiguousarray(os_[..., 1]))

    jf = jdk.chunk_mulreduce_df(jv, joh, jol, chlist, True, interpret=True,
                                force_fused=True)
    jc = jdk.chunk_mulreduce_df(jv, joh, jol, chlist, True, force_fused=False)
    table = tdk.chunk_list_table(chlist)
    tf = tdk.dfmulred_chunks(tv[:, 0], tv[:, 1], toh, tol_, table)
    tc = tdk.chunk_reduce_net_df(
        tdf.mul(tdf.DF(tv[:, 0], tv[:, 1]), tdf.DF(toh, tol_)), chlist, True)
    # interleaved [m, 2] values and a (hi, lo) tuple of planes agree
    tt = tdk.dfmulred_chunks(tv[:, 0].contiguous(), tv[:, 1].contiguous(),
                             toh, tol_, table)
    assert torch.equal(tf[0], tt[0]) and torch.equal(tf[1], tt[1])

    # fused against fused: same loop, hi equal, value within 4e-14 * sum|terms|
    np.testing.assert_array_equal(np.asarray(jf[0]), tf[0].numpy())
    a, b = _val(*jf), _val(tf[0].numpy(), tf[1].numpy())
    mag = np.concatenate([
        np.abs(vals64[s0:s0 + r * K] * o64[s0:s0 + r * K]).reshape(K, r).sum(axis=0)
        for s0, r, K in chlist])
    assert (np.abs(a - b) <= 4e-14 * mag).all()
    # chain against chain: same ops and tree, equal
    np.testing.assert_array_equal(np.asarray(jc[0]), tc[0].numpy())
    np.testing.assert_array_equal(np.asarray(jc[1]), tc[1].numpy())
    # fused against chain and the f64 oracle
    c = _val(tc[0].numpy(), tc[1].numpy())
    np.testing.assert_allclose(b, c, rtol=1e-12, atol=1e-15)
    want = np.concatenate([
        (vals64[s0:s0 + r * K] * o64[s0:s0 + r * K]).reshape(K, r).sum(axis=0)
        for s0, r, K in chlist])
    np.testing.assert_allclose(b, want, rtol=1e-12, atol=1e-15)

    # the slot layout selects the path: column-major chunks take K2 (values
    # interleaved or as a tuple of planes), row-major chunks the chain
    for vals in (tv, (tv[:, 0].contiguous(), tv[:, 1].contiguous())):
        tk = tdk.chunk_mulreduce_df(vals, toh, tol_, chlist, True)
        assert torch.equal(tk[0], tf[0]) and torch.equal(tk[1], tf[1])
    tr = tdk.chunk_mulreduce_df(tv, toh, tol_, chlist, False)
    jr = jdk.chunk_mulreduce_df(jv, joh, jol, chlist, False, force_fused=False)
    np.testing.assert_array_equal(np.asarray(jr[0]), tr[0].numpy())
    np.testing.assert_array_equal(np.asarray(jr[1]), tr[1].numpy())


def test_dfmulred_rejects_bad_planes():
    a = torch.zeros(3, 8)
    with pytest.raises(ValueError):
        tdk.dfmulred(a, a, a, a.double())
    with pytest.raises(ValueError):
        tdk.dfmulred(a, a, a, torch.zeros(3, 9))
    with pytest.raises(ValueError):
        tdk.dfmulred(a[0], a[0], a[0], a[0])


def test_cpu_tensors_never_touch_the_cuda_library(monkeypatch):
    """On CPU tensors both wrappers take their plain versions: no build, no
    library load, no launch count."""
    from lilac_tpu_torch.kernels import routed as trd
    from lilac_tpu_torch.kernels import routenet as trn

    def boom(*a, **k):
        raise AssertionError("CUDA library touched for a CPU tensor")

    monkeypatch.setattr(_cuda, "load", boom)
    monkeypatch.setattr(_cuda, "build_all", boom)
    before = (tdk.dfmulred.launches, trd.routed_apply.launches,
              trd.routed_apply.stage_launches)
    a = torch.ones(4, 16)
    yh, yl = tdk.dfmulred(a, torch.zeros_like(a), a, torch.zeros_like(a))
    assert torch.equal(yh, torch.full((16,), 4.0)) and not yl.any()
    idx = np.random.default_rng(0).integers(0, 1024, size=(1, 1024))
    net = trn.build_gather_network(idx, 1024, 1024, mode="monotone")
    x = torch.arange(1024, dtype=torch.float32)
    (out,) = trd.routed_apply([x.view(8, 128)], trd.masks_device(net, "cpu"),
                              net.kinds, net.dists)
    np.testing.assert_array_equal(out.numpy().reshape(-1), idx[0].astype(np.float32))
    assert before == (tdk.dfmulred.launches, trd.routed_apply.launches,
                      trd.routed_apply.stage_launches)
    # and with no compiler at hand a build raises instead of falling back
    monkeypatch.undo()
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "/nonexistent")
    import os

    if not os.path.exists("/usr/local/cuda/bin/nvcc"):
        with pytest.raises(RuntimeError):
            _cuda.build_all()
