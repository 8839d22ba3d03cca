"""lilac_tpu_torch routing networks and routed SpMV against the JAX package.

Host-side plan arrays are required to be bit-identical. routed_apply only
moves values, so its plain version equals the Pallas kernel (interpret
mode) and the numpy applier bit for bit. SpMV results are compared through
convert_reference on the SAME plan, with the tolerance stated per test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lilac_tpu.kernels import routed as jrd
from lilac_tpu.kernels import routed_spmv as jrs
from lilac_tpu.kernels import routenet as jrn
from lilac_tpu.ops import dfloat as jdf
from lilac_tpu_torch import convert_reference as cr
from lilac_tpu_torch.kernels import routed as trd
from lilac_tpu_torch.kernels import routed_spmv as trs
from lilac_tpu_torch.kernels import routenet as trn
from lilac_tpu_torch.ops import dfloat as tdf


def _idx(seed, B, m, ncol):
    return np.random.default_rng(seed).integers(0, ncol, size=(B, m))


def _csr(seed, n, ncol, kmin, kmax):
    rng = np.random.default_rng(seed)
    counts = rng.integers(kmin, kmax + 1, size=n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    indices = np.concatenate(
        [np.sort(rng.choice(ncol, size=k, replace=False)) for k in counts]
    ).astype(np.int32)
    data = rng.standard_normal(len(indices))
    return indptr.astype(np.int32), indices, data, (n, ncol)


def _to_torch_mat(M) -> trs.RoutedMat:
    return cr.routed_mat_from_arrays(
        np.asarray(M.masks), np.asarray(M.vals), M.kinds, M.dists, M.chunks,
        None if M.inv_perm is None else np.asarray(M.inv_perm),
        M.shape, M.m, M.colmajor, device="cpu",
    )


@pytest.mark.parametrize("mode", ["benes", "monotone"])
@pytest.mark.parametrize("m,ncol", [(1024, 700), (2048, 2048)])
def test_gather_network_bit_identical(mode, m, ncol):
    idx = _idx(3, 3, m, ncol)
    jn = jrn.build_gather_network(idx, ncol, m, mode=mode)
    tn = trn.build_gather_network(idx, ncol, m, mode=mode)
    assert jn.kinds == tn.kinds and jn.dists == tn.dists and jn.m == tn.m
    np.testing.assert_array_equal(jn.masks, tn.masks)
    np.testing.assert_array_equal(
        np.asarray(jrd.masks_device(jn)), trd.masks_device(tn, "cpu").numpy()
    )
    x = np.random.default_rng(4).standard_normal(m)
    np.testing.assert_array_equal(
        tn.apply_host(np.broadcast_to(x, (3, m))), x[idx]
    )


def test_benes_numpy_fallback_matches_native():
    perm = np.stack([np.random.default_rng(s).permutation(256) for s in (0, 1)])
    want = trn.benes_route_batched(perm)
    got = trn._benes_stages(perm)
    assert [d for d, _ in got] == [d for d, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a, bool), np.asarray(b, bool))


@pytest.mark.parametrize("m", [1024, 2048])
@pytest.mark.parametrize("mode", ["benes", "monotone"])
@pytest.mark.parametrize("nplanes,dtype", [(1, np.float32), (2, np.float32),
                                           (1, np.float64)])
def test_routed_apply_plain_matches_apply_host(m, mode, nplanes, dtype):
    B, ncol = 3, m - 300
    idx = _idx(5, B, m, ncol)
    net = trn.build_gather_network(idx, ncol, m, mode=mode)
    if mode == "monotone":
        assert set(net.kinds) == {"xor", "shift", "shiftl"}
    masks = trd.masks_device(net, "cpu")
    rng = np.random.default_rng(6)
    xs = [rng.standard_normal(m).astype(dtype) for _ in range(nplanes)]
    # the wrapper takes the plain version for CPU tensors
    outs = trd.routed_apply(
        [torch.as_tensor(x).view(m // 128, 128) for x in xs],
        masks, net.kinds, net.dists,
    )
    assert len(outs) == nplanes
    for x, o in zip(xs, outs):
        assert o.shape == (B, m // 128, 128) and o.dtype == torch.as_tensor(x).dtype
        got = o.numpy().reshape(B, m)
        np.testing.assert_array_equal(got, net.apply_host(np.broadcast_to(x, (B, m))))
        np.testing.assert_array_equal(got, x[idx])


@pytest.mark.parametrize("m,mode,nplanes", [
    (1024, "benes", 1), (1024, "monotone", 2),
    (2048, "monotone", 1), (2048, "benes", 2),
])
def test_routed_apply_plain_matches_pallas_interpret(m, mode, nplanes):
    B, ncol = 2, m - 100
    idx = _idx(7, B, m, ncol)
    net = trn.build_gather_network(idx, ncol, m, mode=mode)
    packed = trd.masks_packed(net.masks)
    rng = np.random.default_rng(8)
    xs = [rng.standard_normal(m).astype(np.float32) for _ in range(nplanes)]
    want = jrd.routed_apply(
        [jnp.asarray(x.reshape(m // 128, 128)) for x in xs],
        jnp.asarray(packed), net.kinds, net.dists, interpret=True,
    )
    got = trd.routed_apply_plain(
        [torch.as_tensor(x).view(m // 128, 128) for x in xs],
        torch.as_tensor(packed), net.kinds, net.dists,
    )
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


def test_routed_apply_rejects_bad_arguments():
    net = trn.build_gather_network(_idx(9, 1, 1024, 1024), 1024, 1024, mode="benes")
    masks = trd.masks_device(net, "cpu")
    x = torch.zeros(8, 128)
    with pytest.raises(ValueError):
        trd.routed_apply([x.to(torch.float16)], masks, net.kinds, net.dists)
    with pytest.raises(ValueError):
        trd.routed_apply([x], masks, net.kinds[:-1], net.dists[:-1][:3])
    with pytest.raises(ValueError):
        trd.routed_apply([x[:4]], masks, net.kinds, net.dists)
    with pytest.raises(ValueError):
        trd.routed_apply([x, x, x], masks, net.kinds, net.dists)
    with pytest.raises(ValueError):
        trd.check_table_feasible(1536)
    with pytest.raises(ValueError):
        trd.check_table_feasible(1024, nets=70000)
    trd.check_table_feasible(1 << 22, nets=64)  # no on-chip budget bounds m


@pytest.mark.parametrize("dtype", ["f32", "f64", "df64"])
@pytest.mark.parametrize("uniform", [False, True])
def test_build_routed_csr_bit_identical(dtype, uniform):
    indptr, indices, data, shape = _csr(10, 300, 900, 5 if uniform else 1, 6 if uniform else 20)
    J = jrs.build_routed_csr(indptr, indices, data, shape, dtype=dtype)
    T = trs.build_routed_csr(indptr, indices, data, shape, dtype=dtype, device="cpu")
    assert J.kinds == T.kinds and J.dists == T.dists
    assert tuple(J.chunks) == T.chunks and J.m == T.m and J.shape == T.shape
    assert bool(J.colmajor) == T.colmajor
    np.testing.assert_array_equal(np.asarray(J.masks), T.masks.numpy())
    np.testing.assert_array_equal(np.asarray(J.vals), T.vals.numpy())
    assert (J.inv_perm is None) == (T.inv_perm is None) == uniform
    if not uniform:
        np.testing.assert_array_equal(np.asarray(J.inv_perm), T.inv_perm.numpy())


def test_routed_spmv_matches_reference_on_same_plan():
    """f32 and f64: the JAX kernel (interpret) and the port on one plan.
    The routed values are identical; the row sums differ by summation
    order only: 1e-6 (f32) and 1e-13 (f64) of max|y|."""
    indptr, indices, data, shape = _csr(11, 200, 600, 1, 12)
    x = np.random.default_rng(12).standard_normal(shape[1])
    import scipy.sparse as sp

    want = sp.csr_matrix((data, indices, indptr), shape=shape) @ x
    for dtype, npt, tol in (("f32", np.float32, 1e-6), ("f64", np.float64, 1e-13)):
        J = jrs.build_routed_csr(indptr, indices, data, shape, dtype=dtype)
        T = _to_torch_mat(J)
        yj = np.asarray(jrs.routed_spmv(J, jnp.asarray(x.astype(npt)), interpret=True))
        yt = trs.routed_spmv(T, torch.as_tensor(x.astype(npt))).numpy()
        scale = np.abs(want).max()
        assert yt.shape == (shape[0],)
        assert np.abs(yt - yj).max() <= tol * scale
        assert np.abs(yt - want).max() <= 10 * tol * scale


def _chain_product(T: trs.RoutedMat, x: tdf.DF) -> tdf.DF:
    """routed_spmv_df with the op chain (df.mul + pairwise df-sum tree) for
    the row sums, on the plan's own slot products."""
    oh, ol = trd.routed_apply([trs._pad_plane(x.hi, T.m), trs._pad_plane(x.lo, T.m)],
                              T.masks, T.kinds, T.dists)
    B = len(T.chunks)
    prod = tdf.mul(tdf.DF(T.vals[..., 0], T.vals[..., 1]),
                   tdf.DF(oh.view(B, T.m), ol.view(B, T.m)))
    hi, lo = trs._chunk_reduce_df(prod, T.chunks, T.colmajor)
    if T.inv_perm is not None:
        hi, lo = hi[T.inv_perm], lo[T.inv_perm]
    return tdf.DF(hi[: T.shape[0]], lo[: T.shape[0]])


@pytest.mark.parametrize("fused", ["1", "0"])
def test_routed_spmv_df_matches_reference_on_same_plan(fused):
    """df64: the JAX CPU path sums by the op chain; the port by dot2
    (routed_spmv_df, "1") and, on the same slot products, by the same
    chain ("0", then bit-identical)."""
    indptr, indices, data, shape = _csr(13, 200, 600, 1, 12)
    x = np.random.default_rng(14).standard_normal(shape[1])
    J = jrs.build_routed_csr(indptr, indices, data, shape, dtype="df64")
    T = _to_torch_mat(J)
    yj = jrs.routed_spmv_df(J, jdf.from_f64(x), interpret=True)
    xt = tdf.from_f64(x, device="cpu")
    yt = trs.routed_spmv_df(T, xt) if fused == "1" else _chain_product(T, xt)
    if fused == "0":
        np.testing.assert_array_equal(np.asarray(yj.hi), yt.hi.numpy())
        np.testing.assert_array_equal(np.asarray(yj.lo), yt.lo.numpy())
    a, b = jdf.to_f64(yj), tdf.to_f64(yt)
    assert np.abs(a - b).max() <= 1e-13 * np.abs(a).max()
    import scipy.sparse as sp

    want = sp.csr_matrix((data, indices, indptr), shape=shape) @ x
    assert np.abs(b - want).max() <= 1e-13 * np.abs(want).max()


@pytest.mark.parametrize("dtype", ["f32", "df64"])
def test_plan_files_interchange(tmp_path, dtype):
    """A plan saved by either package loads in the other, field for field."""
    indptr, indices, data, shape = _csr(15, 150, 500, 1, 9)
    T = trs.build_routed_csr(indptr, indices, data, shape, dtype=dtype, device="cpu")
    pt, pj = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    trs.save_routed(pt, T)
    J = jrs.load_routed(pt)
    assert isinstance(J, jrs.RoutedMat)
    jrs.save_routed(pj, J)
    T2 = trs.load_routed(pj, device="cpu")
    for a, b in ((T, T2), (T, _to_torch_mat(J))):
        assert (a.kinds, a.dists, a.chunks, a.shape, a.m, a.colmajor) == (
            b.kinds, b.dists, b.chunks, b.shape, b.m, b.colmajor)
        assert torch.equal(a.masks, b.masks) and torch.equal(a.vals, b.vals)
        assert torch.equal(a.inv_perm, b.inv_perm)
    # another cache version is refused, not misread
    z = dict(np.load(pt))
    z["version"] = np.asarray(1)
    np.savez(str(tmp_path / "old.npz"), **z)
    assert trs.load_routed(str(tmp_path / "old.npz"), device="cpu") is None
    # a plan class neither package writes is refused, not misread (column-
    # segmented and hierarchical plans interchange too: see
    # test_torch_routed_seg.py and test_torch_hier.py)
    z["version"], z["cls"] = np.asarray(2), np.asarray("RoutedMatNone")
    np.savez(str(tmp_path / "other.npz"), **z)
    with pytest.raises(ValueError, match="unknown plan class"):
        trs.load_routed(str(tmp_path / "other.npz"), device="cpu")
