"""Column-segmented routing of lilac_tpu_torch against the JAX package:
build_routed_csr_seg, routed_seg_spmv(_df), the seg plan files and the
factored dispatch.

The containers must be bit-identical on the reference's own cases
(tests/test_routed.py: 800 x 3000 f32 and 600 x 2500 df64 at seg_size
1024, three segments). The products run K1 and K2 through their plain
versions (CPU tensors) and are held to the reference's Pallas kernels in
interpret mode on one small case a value policy: f32 to 2e-6 and df64 to
4e-14 of sum |a x| a row (the segment sums are added in the same order;
f32 products sum in another order within a chunk, and the port's df64 row
sums are K2's dot2 where the reference's CPU path takes the df.sum_df0
tree). On the larger cases they are held to the f64 product with the
reference tests' own tolerances.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lilac_tpu.kernels import routed_spmv as jrs
from lilac_tpu.ops import dfloat as jdf
from lilac_tpu_torch.kernels import factored as tfac
from lilac_tpu_torch.kernels import routed as trd
from lilac_tpu_torch.kernels import routed_spmv as trs
from lilac_tpu_torch.ops import dfloat as tdf
from tests.test_routed import _random_csr_spread

torch.set_num_threads(1)

CASES = {"f32": (800, 3000, 7.0), "df64": (600, 2500, 6.0)}


def _build_both(dtype, n, ncol, mean, seed=1234, seg_size=1024):
    A = _random_csr_spread(np.random.default_rng(seed), n, ncol, mean)
    J = jrs.build_routed_csr_seg(A.indptr, A.indices, A.data, A.shape, dtype=dtype,
                                 seg_size=seg_size)
    T = trs.build_routed_csr_seg(A.indptr, A.indices, A.data, A.shape, dtype=dtype,
                                 seg_size=seg_size, device="cpu")
    return A, J, T


def _same(T, J):
    assert isinstance(T, trs.RoutedMatSeg)
    assert (T.kinds, T.dists, T.chunks) == (J.kinds, J.dists, J.chunks)
    assert (T.shape, T.m, T.seg_size, T.colmajor) == (tuple(J.shape), J.m, J.seg_size,
                                                      J.colmajor)
    assert len(T.masks) == len(J.masks) == len(T.vals)
    for a, b in zip(T.masks + T.vals, J.masks + J.vals):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(T.inv_perm.numpy(), np.asarray(J.inv_perm))


def _product(M, x, dtype, mod):
    if dtype == "df64":
        dfm = tdf if mod is trs else jdf
        xin = tdf.from_f64(x, device="cpu") if mod is trs else jdf.from_f64(x)
        kw = {} if mod is trs else {"interpret": True}
        return dfm.to_f64(mod.routed_seg_spmv_df(M, xin, **kw))
    if mod is trs:
        return trs.routed_seg_spmv(M, torch.as_tensor(x)).numpy().astype(np.float64)
    return np.asarray(jrs.routed_seg_spmv(M, jnp.asarray(x), interpret=True),
                      dtype=np.float64)


@pytest.mark.parametrize("dtype", ["f32", "df64"])
def test_seg_build_bit_for_bit_and_product(dtype):
    A, J, T = _build_both(dtype, *CASES[dtype])
    assert len(T.masks) == 3
    _same(T, J)
    x = np.random.default_rng(2).standard_normal(A.shape[1])
    if dtype == "f32":
        x = x.astype(np.float32)
    y = _product(T, x, dtype, trs)
    tol = {"f32": 2e-5, "df64": 1e-13}[dtype]  # tests/test_routed.py's
    np.testing.assert_allclose(y, A @ x.astype(np.float64), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["f32", "df64"])
def test_seg_product_matches_the_pallas_kernels(dtype):
    A, J, T = _build_both(dtype, 60, 1500, 4.0, seed=9)
    assert len(T.masks) == 2
    x = np.random.default_rng(3).standard_normal(A.shape[1])
    if dtype == "f32":
        x = x.astype(np.float32)
    yt, yj = _product(T, x, dtype, trs), _product(J, x, dtype, jrs)
    scale = abs(A) @ np.abs(x.astype(np.float64))
    tol = {"f32": 2e-6, "df64": 4e-14}[dtype]
    assert np.all(np.abs(yt - yj) <= tol * scale)


@pytest.mark.parametrize("dtype", ["f32", "df64"])
def test_seg_plan_files_interchange(tmp_path, dtype):
    """A seg plan file the JAX package wrote loads in the port and gives the
    same product bit for bit; the port's file loads in the JAX package."""
    A, J, T = _build_both(dtype, 200, 2300, 5.0, seed=4)
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jrs.save_routed(pj, J)
    L = trs.load_routed(pj, device="cpu")
    _same(L, J)
    x = np.random.default_rng(6).standard_normal(A.shape[1])
    if dtype == "f32":
        x = x.astype(np.float32)
    np.testing.assert_array_equal(_product(L, x, dtype, trs), _product(T, x, dtype, trs))
    trs.save_routed(pt, T)
    J2 = jrs.load_routed(pt)
    assert isinstance(J2, jrs.RoutedMatSeg)
    _same(T, J2)
    z = np.load(pt)
    assert {"nseg", "seg_size", "inv_perm", "colmajor", "masks2", "vals2", "kinds2",
            "dists2", "chunks2"} <= set(z.files)


def test_seg_limits_and_factored_dispatch():
    """A segment is one table: a power of two >= 1024, at most 2^18; the
    factored operator dispatches a RoutedMatSeg to routed_seg_spmv(_df)."""
    A = _random_csr_spread(np.random.default_rng(5), 100, 1500, 4.0)
    for bad in (1000, 1 << 19):
        with pytest.raises(ValueError):
            trs.build_routed_csr_seg(A.indptr, A.indices, A.data, A.shape,
                                     seg_size=bad, device="cpu")
    x = np.random.default_rng(7).standard_normal(1500)
    for dtype in ("f32", "df64"):
        M = trs.build_routed_csr_seg(A.indptr, A.indices, A.data, A.shape,
                                     dtype=dtype, seg_size=1024, device="cpu")
        assert len(M.masks) == 2
        before = trd.routed_apply.launches
        if dtype == "df64":
            xd = tdf.from_f64(x, device="cpu")
            a, b = tfac._spmv_any_df(M, xd), trs.routed_seg_spmv_df(M, xd)
            assert torch.equal(a.hi, b.hi) and torch.equal(a.lo, b.lo)
        else:
            xt = torch.as_tensor(x, dtype=torch.float32)
            assert torch.equal(tfac._spmv_any(M, xt), trs.routed_seg_spmv(M, xt))
        assert trd.routed_apply.launches == before  # CPU tensors: plain versions
