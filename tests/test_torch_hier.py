"""lilac_tpu_torch hierarchical routing against the JAX package, on the CPU.

compile_hier's pass descriptors and mask arrays are required to be
bit-identical. The four pass appliers only move words, so each plain
version equals its Pallas counterpart (interpret mode) bit for bit, net
batched and for one net, reading through the identity and through a
scrambled block layout; whole schedules equal the numpy applier of the
network. SpMV results are compared on the SAME plan, built by the JAX
package and carried across by convert_reference.hier_mat_from_arrays, with
the tolerance stated per test. Sizes are small (bl = 256, a few thousand
slots) so that the interpret-mode calls stay cheap.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lilac_tpu.kernels import routed as jrd
from lilac_tpu.kernels import routed_spmv as jrs
from lilac_tpu.ops import dfloat as jdf
from lilac_tpu_torch import convert_reference as cr
from lilac_tpu_torch.kernels import factored as tfac
from lilac_tpu_torch.kernels import routed as trd
from lilac_tpu_torch.kernels import routed_spmv as trs
from lilac_tpu_torch.kernels import routenet as trn
from lilac_tpu_torch.ops import dfloat as tdf
from lilac_tpu_torch.workloads import npb_cg as trun

BL = 256


def _network(seed, B, m, ncol, dense=0):
    """A Benes gather network over m slots; `dense` slots of every net ask
    for one column, so that its broadcast run needs block-aligned shifts."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, ncol, size=(B, m))
    for b in range(B):
        idx[b, rng.choice(m, size=dense, replace=False)] = 3 + b
    return idx, trn.build_gather_network(idx, ncol, m, drop_empty=False)


def _csr(seed, n, ncol, kmin, kmax, dense_rows=0):
    rng = np.random.default_rng(seed)
    counts = rng.integers(kmin, kmax + 1, size=n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    indices = rng.integers(0, ncol, size=int(indptr[-1]))
    indices[indptr[rng.choice(n, size=dense_rows, replace=False)]] = 7
    return indptr, indices, rng.standard_normal(len(indices)), (n, ncol)


def _dense_product(indptr, indices, data, shape, x):
    """(A x, |A| |x|) in f64, duplicates summed."""
    rows = np.repeat(np.arange(shape[0]), np.diff(indptr))
    y = np.zeros(shape[0])
    s = np.zeros(shape[0])
    np.add.at(y, rows, data * x[indices])
    np.add.at(s, rows, np.abs(data * x[indices]))
    return y, s


@pytest.mark.parametrize("gmax", [1, 2, 3])
@pytest.mark.parametrize("m,dense", [(2048, 0), (4096, 700)])
def test_compile_hier_bit_identical(gmax, m, dense):
    _, net = _network(20, 2, m, m - 500, dense)
    for b in range(2):
        want = jrd.compile_hier(net.kinds, net.dists, net.masks[:, b, :], BL, gmax=gmax)
        got = trd.compile_hier(net.kinds, net.dists, net.masks[:, b, :], BL, gmax=gmax)
        assert len(want) == len(got)
        for w, g in zip(want, got):
            assert w[:-1] == g[:-1]  # kind, stage kinds / bits, distances
            assert isinstance(g[-1], np.ndarray) and g[-1].dtype == np.int8
            np.testing.assert_array_equal(np.asarray(w[-1]), g[-1])
    kinds = {p[0] for p in got}
    assert {"inner", "butterfly"} <= kinds
    assert "window" in kinds and ("bigshift" in kinds) == bool(dense)
    if gmax < 3:
        assert all(len(p[1]) <= gmax for p in got if p[0] == "butterfly")
    with pytest.raises(ValueError):
        trd.compile_hier(("shiftl",), (1,), net.masks[:1, 0, :], BL)
    with pytest.raises(ValueError):
        trd.compile_hier(net.kinds, net.dists, net.masks[:, 0, :], 384)


# one pass of each kind over 8 blocks of 256 slots: (meta, mask shape without
# the net axis, mask bits in use)
_NB, _R = 8, BL // 128
_PASSES = {
    "inner": (("inner", ("xor",) * 10, (128, 1, 64, 2, 32, 4, 16, 8, 1, 128)),
              (_NB, 2, _R, 128), 8),
    "butterfly": (("butterfly", (2, 0)), (_NB // 4, 4 * _R, 128), 2),
    "window": (("window", (1, 2, 4, 8, 16, 32, 64, 100)), (_NB, 2 * _R, 128), 8),
    "bigshift": (("bigshift", 3 * BL), (_NB, _R, 128), 1),
}
_JAX_FN = {
    "inner": (jrd.routed_apply_sliced_b, jrd.routed_apply_sliced),
    "butterfly": (jrd.butterfly_apply_b, jrd.butterfly_apply),
    "window": (jrd.window_shift_apply_b, jrd.window_shift_apply),
    "bigshift": (jrd.bigshift_apply_b, jrd.bigshift_apply),
}
_TORCH_FN = {
    "inner": (trd.routed_apply_sliced_b, trd.routed_apply_sliced,
              trd.routed_apply_sliced_plain),
    "butterfly": (trd.butterfly_apply_b, trd.butterfly_apply,
                  trd.butterfly_apply_plain),
    "window": (trd.window_shift_apply_b, trd.window_shift_apply,
               trd.window_shift_apply_plain),
    "bigshift": (trd.bigshift_apply_b, trd.bigshift_apply, trd.bigshift_apply_plain),
}


def _call(fn, meta, planes, masks, layout, **kw):
    if meta[0] == "inner":
        return fn(planes, masks, meta[1], meta[2], layout=layout, **kw), None
    out = fn(planes, masks, meta[1], BL, layout=layout, **kw)
    return out if meta[0] == "butterfly" else (out, None)


@pytest.mark.parametrize("layout", [None, (1, 2, 0)], ids=["identity", "scrambled"])
@pytest.mark.parametrize("batched", [True, False], ids=["batched", "one_net"])
@pytest.mark.parametrize("kind", ["inner", "butterfly", "window", "bigshift"])
def test_plain_applier_matches_pallas_interpret(kind, batched, layout):
    """Random masks, an f32 (hi, lo) pair of planes: the wrapper (which takes
    the plain version for CPU tensors) and the plain version itself equal
    the Pallas kernel run in interpret mode, exactly."""
    meta, mshape, bits = _PASSES[kind]
    rng = np.random.default_rng(21)
    N = 2
    m = _NB * BL
    masks = rng.integers(0, 1 << bits, size=((N,) if batched else ()) + mshape,
                         dtype=np.uint8).view(np.int8)
    # the net-batched kernels take one shared input or one plane per net
    per_net = batched and kind in ("butterfly", "window")
    xs = [rng.standard_normal(((N,) if per_net else ()) + (m // 128, 128))
          .astype(np.float32) for _ in range(2)]
    want, want_layout = _call(_JAX_FN[kind][0 if batched else 1], meta,
                              [jnp.asarray(x) for x in xs], jnp.asarray(masks),
                              layout, interpret=True)
    tx, tm = [torch.as_tensor(x) for x in xs], torch.as_tensor(masks)
    wrapper, plain = _TORCH_FN[kind][0 if batched else 1], _TORCH_FN[kind][2]
    for fn in (wrapper, plain):
        got, got_layout = _call(fn, meta, tx, tm, layout)
        assert got_layout == want_layout
        assert len(got) == len(want) == 2
        for w, g in zip(want, got):
            assert g.shape == ((N,) if batched else ()) + (m // 128, 128)
            np.testing.assert_array_equal(np.asarray(w), g.numpy())
    assert wrapper.launches == 0  # only a launch of the CUDA kernel counts


@pytest.mark.parametrize("gmax", [1, 2, 3])
@pytest.mark.parametrize("nplanes,dtype", [(2, np.float32), (1, np.float64)])
def test_hier_apply_matches_apply_host(gmax, nplanes, dtype):
    """Whole schedules over 32 blocks (5 block bits, block-aligned shifts
    included), one net and net-batched: equal to the numpy applier and to
    x[idx], which also proves the layout tracking and the final relayout."""
    B, m = 3, 8192
    idx, net = _network(22, B, m, 3000, dense=600)
    per_net = [trd.compile_hier(net.kinds, net.dists, net.masks[:, b, :], BL, gmax=gmax)
               for b in range(B)]
    metas = tuple(p[:-1] for p in per_net[0])
    assert {mt[0] for mt in metas} == {"inner", "butterfly", "window", "bigshift"}
    stacked = tuple(torch.as_tensor(np.stack([pn[j][-1] for pn in per_net]))
                    for j in range(len(metas)))
    rng = np.random.default_rng(23)
    xs = [rng.standard_normal(m).astype(dtype) for _ in range(nplanes)]
    planes = [torch.as_tensor(x).view(m // 128, 128) for x in xs]
    outs = trd.hier_apply_batched(planes, metas, stacked, BL)
    outs0 = trd.hier_apply(
        planes, [p[:-1] + (torch.as_tensor(p[-1]),) for p in per_net[0]], BL)
    for x, o, o0 in zip(xs, outs, outs0):
        host = net.apply_host(np.broadcast_to(x, (B, m)))
        assert o.shape == (B, m // 128, 128) and o0.shape == (m // 128, 128)
        np.testing.assert_array_equal(o.numpy().reshape(B, m), host)
        np.testing.assert_array_equal(o.numpy().reshape(B, m), x[idx])
        np.testing.assert_array_equal(o0.numpy().reshape(m), host[0])


def test_hier_apply_matches_pallas_interpret():
    """One schedule end to end through both packages (gmax 2, one net)."""
    m = 2048
    _, net = _network(24, 1, m, 1500, dense=300)
    passes = trd.compile_hier(net.kinds, net.dists, net.masks[:, 0, :], BL, gmax=2)
    x = np.random.default_rng(25).standard_normal(m).astype(np.float32)
    (want,) = jrd.hier_apply(
        [jnp.asarray(x.reshape(-1, 128))],
        [p[:-1] + (jnp.asarray(p[-1]),) for p in passes], BL, interpret=True)
    (got,) = trd.hier_apply(
        [torch.as_tensor(x).view(-1, 128)],
        [p[:-1] + (torch.as_tensor(p[-1]),) for p in passes], BL)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_hier_appliers_reject_bad_arguments():
    meta, mshape, _ = _PASSES["inner"]
    masks = torch.zeros(mshape, dtype=torch.int8)
    x = torch.zeros(_NB * _R, 128)
    with pytest.raises(ValueError):
        trd.routed_apply_sliced([x[:4]], masks, meta[1], meta[2])
    with pytest.raises(ValueError):
        trd.routed_apply_sliced([x], masks, meta[1][:3], meta[2][:3])
    with pytest.raises(ValueError):
        trd.routed_apply_sliced([x], masks, meta[1], meta[2], layout=(0, 1, 1))
    with pytest.raises(ValueError):
        trd.window_shift_apply([x], torch.zeros(_PASSES["window"][1], dtype=torch.int8),
                               (200, 100), BL)
    with pytest.raises(ValueError):
        trd.bigshift_apply([x], torch.zeros(_PASSES["bigshift"][1], dtype=torch.int8),
                           BL + 1, BL)
    with pytest.raises(ValueError):
        trd.butterfly_apply([x], torch.zeros(_PASSES["butterfly"][1], dtype=torch.int8),
                            (1, 1), BL)


def test_shared_memory_feasibility():
    """The block length is bounded by a thread block's shared memory, not by
    the JAX package's on-chip budget: its default 2^16 is refused, 2^13 (the
    derived default) and an f64 plane at 2^14 fit, and the builder refuses
    before it routes anything."""
    assert trd.default_hier_bl() == 1 << 13
    assert trd.default_hier_bl(48 * 1024) == 1 << 11
    assert trd.hier_gmax(1 << 13, 2) == 3
    inner = (("inner", (), ()), ("butterfly", (0, 1, 2)), ("window", ()), ("bigshift", 0))
    trd.check_smem_feasible(inner, 1 << 13, 2, 4)
    trd.check_smem_feasible(inner, 1 << 14, 1, 8)
    with pytest.raises(ValueError, match="shared memory"):
        trd.check_smem_feasible(inner, 1 << 16, 2, 4)
    with pytest.raises(ValueError, match="butterfly group"):
        trd.check_smem_feasible((("butterfly", (0, 1, 2, 3)),), 1 << 13, 2, 4)
    with pytest.raises(ValueError, match="power of two"):
        trd.check_smem_feasible(inner, 384, 1, 4)
    indptr, indices, data, shape = _csr(26, 4, 4, 2, 2)
    with pytest.raises(ValueError, match="shared memory"):
        trs.build_routed_csr_hier(indptr, indices, data, shape, dtype="df64", bl=1 << 16)


def _jax_hier(indptr, indices, data, shape, dtype):
    return jrs.build_routed_csr_hier(indptr, indices, data, shape, dtype=dtype, bl=BL)


def _carry(M, pack):
    """A JAX-built RoutedMatHier as the port's container, on the CPU."""
    return cr.hier_mat_from_arrays(
        [[np.asarray(mk) for mk in net.pass_masks] for net in M.nets],
        [net.pass_meta for net in M.nets],
        [np.asarray(v) for v in M.vals],
        None if M.unperm is None else [np.asarray(mk) for mk in M.unperm.pass_masks],
        None if M.unperm is None else M.unperm.pass_meta,
        M.chunks, M.shape, M.m, M.m_out, M.bl, M.n_nz, M.colmajor,
        device="cpu", pack=pack)


@pytest.mark.parametrize("dtype", ["f32", "f64", "df64"])
def test_build_routed_csr_hier_bit_identical(dtype, monkeypatch):
    monkeypatch.setenv("LILAC_HIER_GMAX", "2")  # the JAX default at this bl is its own
    indptr, indices, data, shape = _csr(27, 1500, 1500, 1, 9, dense_rows=400)
    J = _jax_hier(indptr, indices, data, shape, dtype)
    T = trs.build_routed_csr_hier(indptr, indices, data, shape, dtype=dtype, bl=BL)
    assert (J.chunks, J.shape, J.m, J.m_out, J.bl, J.n_nz, bool(J.colmajor)) == (
        T.chunks, T.shape, T.m, T.m_out, T.bl, T.n_nz, T.colmajor)
    assert len(J.nets) == len(T.nets) > 1 and T.unperm is not None
    for jn, tn in zip(J.nets + (J.unperm,), T.nets + (T.unperm,)):
        assert jn.pass_meta == tn.pass_meta
        for a, b in zip(jn.pass_masks, tn.pass_masks):
            np.testing.assert_array_equal(np.asarray(a), b)
    for a, b in zip(J.vals, T.vals):
        np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("pack", [True, False], ids=["packed", "net_by_net"])
@pytest.mark.parametrize("dtype", ["f32", "df64"])
def test_routed_hier_spmv_matches_reference_on_same_plan(dtype, pack):
    """Unsorted rows (the un-permute network runs) and a dense column. f32:
    the routed values are identical, the row sums differ by summation order,
    1e-6 * sum|v x|. df64: the JAX CPU path sums by the op chain, the port by
    the compensated dot: 4e-14 * sum|v x|, also against the f64 product."""
    indptr, indices, data, shape = _csr(28, 1000, 1000, 1, 3, dense_rows=300)
    x = np.random.default_rng(29).standard_normal(shape[1])
    want, scale = _dense_product(indptr, indices, data, shape, x)
    J = _jax_hier(indptr, indices, data, shape, dtype)
    T = _carry(J, pack)
    assert isinstance(T, trs.RoutedMatHierP if pack else trs.RoutedMatHier)
    Jr = jrs.pack_hier(J) if pack else J
    if dtype == "df64":
        yj = jdf.to_f64(jrs.routed_hier_spmv_df(Jr, jdf.from_f64(x), interpret=True))
        yt = tdf.to_f64(trs.routed_hier_spmv_df(T, tdf.from_f64(x, device="cpu")))
        tol = 4e-14
    else:
        yj = np.asarray(jrs.routed_hier_spmv(
            Jr, jnp.asarray(x, jnp.float32), interpret=True), np.float64)
        yt = trs.routed_hier_spmv(T, torch.as_tensor(x, dtype=torch.float32)).numpy()
        tol = 1e-6
    assert yt.shape == yj.shape == (shape[0],)
    assert (np.abs(yt - yj) <= tol * scale).all()
    assert (np.abs(yt - want) <= tol * scale).all()


def test_hier_pack_knob_and_host_staging(monkeypatch):
    indptr, indices, data, shape = _csr(30, 600, 600, 1, 6)
    M = trs.build_routed_csr_hier(indptr, indices, data, shape, dtype="f32", bl=BL)
    assert all(isinstance(mk, np.ndarray) for net in M.nets for mk in net.pass_masks)
    with pytest.raises(TypeError, match="staged on the host"):
        trs.routed_hier_spmv(M, torch.zeros(shape[1]))
    P = trs.maybe_pack_hier(M, "cpu")
    assert isinstance(P, trs.RoutedMatHierP)
    assert sum(len(g.net_ids) for g in P.groups) == len(M.nets)
    monkeypatch.setenv("LILAC_HIER_PACK", "0")
    U = trs.maybe_pack_hier(M, "cpu")
    assert isinstance(U, trs.RoutedMatHier) and isinstance(U.vals[0], torch.Tensor)
    x = torch.as_tensor(np.random.default_rng(31).standard_normal(shape[1]),
                        dtype=torch.float32)
    # packing only batches the launches: the same words, the same sums
    assert torch.equal(trs.routed_hier_spmv(P, x), trs.routed_hier_spmv(U, x))
    assert trs.plan_bytes(P) == trs.plan_bytes(U) == trs.plan_bytes(M)
    assert trs.maybe_pack_hier("anything else", "cpu") == "anything else"
    monkeypatch.setenv("LILAC_HIER_BL", "512")
    monkeypatch.setenv("LILAC_HIER_GMAX", "1")
    assert trs.hier_bl_cfg() == 512 and trs._hier_gmax_cfg(512, "df64") == 1
    monkeypatch.delenv("LILAC_HIER_BL")
    monkeypatch.delenv("LILAC_HIER_GMAX")
    assert trs.hier_bl_cfg() == 1 << 13 and trs._hier_gmax_cfg(1 << 13, "df64") == 3


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_hier_plan_files_interchange(tmp_path, writer):
    """A hier plan saved by either package loads in the other, leaf for
    leaf; one whose block does not fit a thread block's shared memory is
    refused at load with a clear error."""
    indptr, indices, data, shape = _csr(32, 900, 900, 1, 7, dense_rows=300)
    path = str(tmp_path / "plan.npz")
    if writer == "jax":
        A = _jax_hier(indptr, indices, data, shape, "df64")
        jrs.save_routed(path, A)
        B = trs.load_routed(path, device="cpu")
    else:
        A = trs.build_routed_csr_hier(indptr, indices, data, shape, dtype="df64", bl=BL)
        trs.save_routed(path, A)
        B = jrs.load_routed(path)
    assert type(B).__name__ == "RoutedMatHier"
    assert (A.chunks, tuple(A.shape), A.m, A.m_out, A.bl, A.n_nz, bool(A.colmajor)) == (
        B.chunks, tuple(B.shape), B.m, B.m_out, B.bl, B.n_nz, bool(B.colmajor))
    for a, b in zip(A.nets + (A.unperm,), B.nets + (B.unperm,)):
        assert a.pass_meta == b.pass_meta
        for x, y in zip(a.pass_masks, b.pass_masks):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    for x, y in zip(A.vals, B.vals):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    if writer == "torch":
        with pytest.raises(TypeError):
            trs.save_routed(path, trs.pack_hier(A, "cpu"))
        return
    # the loaded plan multiplies like the one it was written from
    x = np.random.default_rng(33).standard_normal(shape[1])
    want, scale = _dense_product(indptr, indices, data, shape, x)
    got = tdf.to_f64(trs.routed_hier_spmv_df(
        trs.maybe_pack_hier(B, "cpu"), tdf.from_f64(x, device="cpu")))
    assert (np.abs(got - want) <= 4e-14 * scale).all()
    # the JAX package's own default block, 2^16 slots, does not fit
    z = dict(np.load(path))
    import json

    meta = json.loads(str(z["meta"]))
    meta["bl"] = 1 << 16
    z["meta"] = np.asarray(json.dumps(meta))
    big = str(tmp_path / "big.npz")
    np.savez(big, **z)
    with pytest.raises(ValueError, match="shared memory"):
        trs.load_routed(big, device="cpu")


@pytest.fixture
def small_hier_classes(tmp_path, monkeypatch):
    """Class S (na = 1400) through the hierarchical plans: the single-table
    limit lowered to 1024 and a forced block of 256 slots (m = 2048: 8
    blocks)."""
    monkeypatch.setenv("LILAC_DATA_DIR", str(tmp_path))
    monkeypatch.setenv("LILAC_FACTORED_SEGMODE", "routed")
    monkeypatch.setenv("LILAC_HIER_BL", str(BL))
    monkeypatch.setattr(tfac, "SINGLE_TABLE_MAX", 1024)
    return tmp_path


@pytest.mark.parametrize("pack", ["1", "0"], ids=["packed", "net_by_net"])
def test_factored_hier_matches_gather_operator(pack, small_hier_classes, monkeypatch):
    """The slice as a whole: hier V and VT from class S's factors give the
    factored df64 product of the gather operator to 1e-13 relative, the
    plans persist under names that carry (bl, gmax), and a second build
    loads them."""
    monkeypatch.setenv("LILAC_HIER_PACK", pack)
    monkeypatch.setenv("LILAC_FACTORED_VT", "plan")  # auto is adj beyond one table
    H, nnz = tfac.build_factored("S", dtype="df64", device="cpu")
    kind = trs.RoutedMatHierP if pack == "1" else trs.RoutedMatHier
    assert isinstance(H.V, kind) and isinstance(H.VT, kind)
    assert H.V.unperm is None and H.VT.unperm is None  # rows relabelled sorted
    assert H.V.bl == BL and H.V.m == 2048
    names = sorted(f.name for f in small_hier_classes.iterdir())
    assert names == ["routed2_S_df64_VT_bl256ga.npz", "routed2_S_df64_V_bl256ga.npz",
                     "routed2_S_df64_meta_bl256ga.npz"], names
    monkeypatch.setattr(
        "lilac_tpu_torch.generate.npb._generate_triples",
        lambda cls: pytest.fail("cache hit regenerated triples"))
    H2, nnz2 = tfac.build_factored("S", dtype="df64", device="cpu")
    assert nnz2 == nnz and isinstance(H2.V, kind) and torch.equal(H.s, H2.s)
    monkeypatch.undo()

    G, nnz_g = tfac.build_factored("S", dtype="df64", device="cpu")  # auto = gather
    assert nnz_g == nnz and not isinstance(G.V, (trs.RoutedMatHier, trs.RoutedMatHierP))
    # the routed operator lives in the relabelled (sigma) space, where only
    # permutation-invariant vectors compare: take x = ones, as NPB does, and
    # compare the sorted entries of y
    x = tdf.from_f64(np.ones(1400), device="cpu")
    for A in (H, H2):
        yh = np.sort(tdf.to_f64(tfac.factored_spmv_df(A, x)))
        yg = np.sort(tdf.to_f64(tfac.factored_spmv_df(G, x)))
        assert np.abs(yh - yg).max() <= 1e-13 * np.abs(yg).max()


def test_npb_class_s_through_hier_plans(small_hier_classes, monkeypatch):
    """NPB class S end to end through the two forward hierarchical plans, cut
    to 4 outer steps: the zeta history agrees with the native-f64 gather
    operator's to 1e-12 relative."""
    monkeypatch.setenv("LILAC_FACTORED_VT", "plan")
    r = trun.run("S", dtype="df64", device="cpu", niter=4)
    assert r.kernel == "factored_routed_df" and r.niter == 4
    assert r.factored_vt == "plan"
    assert r.zeta_history.shape == (4,) and r.zeta_history[-1] == r.zeta
    import os

    os.environ["LILAC_FACTORED_SEGMODE"] = "single"  # the fixture restores it
    g = trun.run("S", dtype="f64", device="cpu", niter=4)
    assert g.kernel == "factored_gather"
    assert np.abs(r.zeta_history - g.zeta_history).max() <= 1e-12 * abs(g.zeta)


def test_hier_modes_that_still_raise(monkeypatch):
    """factored_vt=adj raises for no size; auto resolves as in the reference
    (adj beyond one table, plan below, plan for a gather layout); scan is a
    gather layout (plan); mixed still raises, except with adj, which is
    routed."""
    from lilac_tpu_torch.config import cfg

    monkeypatch.setenv("LILAC_FACTORED_VT", "adj")
    assert tfac._resolve_modes(cfg(), 1_500_000, "cuda") == ("routed", "adj")
    assert tfac._resolve_modes(cfg(), 150_000, "cuda") == ("routed", "adj")
    monkeypatch.delenv("LILAC_FACTORED_VT")
    assert tfac._resolve_modes(cfg(), 1_500_000, "cuda") == ("routed", "adj")
    assert tfac._resolve_modes(cfg(), 1 << 18, "cuda") == ("routed", "plan")
    assert tfac._resolve_modes(cfg(), 1_500_000, "cpu") == ("single", "plan")
    monkeypatch.setenv("LILAC_FACTORED_SEGMODE", "mixed")
    assert tfac._resolve_modes(cfg(), 1_500_000, "cuda") == ("routed", "adj")
    monkeypatch.setenv("LILAC_FACTORED_SEGMODE", "scan")
    assert tfac._resolve_modes(cfg(), 1_500_000, "cuda") == ("scan", "plan")
    monkeypatch.setenv("LILAC_FACTORED_VT", "plan")
    assert tfac._resolve_modes(cfg(), 1_500_000, "cuda") == ("scan", "plan")
    monkeypatch.setenv("LILAC_FACTORED_SEGMODE", "mixed")
    with pytest.raises(NotImplementedError, match="JagELLT"):
        tfac._resolve_modes(cfg(), 1_500_000, "cuda")


# ---- K4 / K6 launch shapes (butterfly_launch_config) --------------------------

H100_SMS = 132


def _all_shapes(bl, g, nplanes, esize):
    return [(s, t) for s in (4, 2, 1) for t in (256, 128, 64, 32)
            if s * t <= bl and (nplanes * s * esize // 4) << g <= trd.BFLY_MAX_WORDS]


@pytest.mark.parametrize("N,ngroups,bl,g,nplanes,esize,want", [
    (1, 8, 8192, 3, 2, 4, (4, 32)),      # K4u: the general matrix's one net
    (16, 32, 8192, 3, 2, 4, (4, 256)),   # K4 / K8 at class D's N = 16
    (16, 64, 8192, 2, 2, 4, (4, 256)),   # K8's g = 2 at class D
    (6, 8, 8192, 3, 2, 4, (4, 256)),     # K4, the general matrix packed
    (1, 64, 8192, 0, 2, 4, (4, 256)),    # K6u
    (16, 256, 8192, 0, 2, 4, (4, 256)),  # K6 at class D's shapes
    (1, 8, 8192, 3, 1, 8, (4, 32)),      # one f64 plane
    (1, 4, 256, 3, 2, 4, (1, 32)),       # too small for 2 an SM: the most blocks
])
def test_butterfly_launch_config(N, ngroups, bl, g, nplanes, esize, want):
    cfg = trd.butterfly_launch_config(N, ngroups, bl, g, nplanes, esize, H100_SMS)
    slots, threads = cfg["slots"], cfg["threads"]
    assert (slots, threads) == want
    assert cfg["grid"] == [bl // (slots * threads), ngroups, N]
    assert cfg["grid"][0] * threads * slots == bl  # every slot once, no idle thread
    assert cfg["blocks"] == cfg["grid"][0] * ngroups * N
    assert (nplanes * slots * esize // 4) << g <= trd.BFLY_MAX_WORDS
    most = max(bl // (s * t) * ngroups * N for s, t in _all_shapes(bl, g, nplanes, esize))
    assert cfg["blocks"] >= min(2 * H100_SMS, most)
    if (N, ngroups) == (1, 8):  # was 4 slots of 256 threads: 64 blocks
        assert cfg["blocks"] >= 2 * H100_SMS


def test_forced_launch_is_checked_on_the_cpu():
    """launch= forces (slots, threads) for checks; a shape the kernel does not
    take raises on every device, and the CPU's plain version ignores a valid
    one."""
    rng = np.random.default_rng(3)
    bl, nblocks = 256, 4
    x = torch.as_tensor(rng.standard_normal(nblocks * bl).astype(np.float32)).view(-1, 128)
    mk = torch.as_tensor(rng.integers(0, 2, size=(nblocks // 2, 4, 128), dtype=np.int8))
    want, lay = trd.butterfly_apply((x,), mk, (1,), bl)
    got, lay2 = trd.butterfly_apply((x,), mk, (1,), bl, launch=(2, 64))
    assert torch.equal(got[0], want[0]) and lay == lay2
    smk = torch.as_tensor(rng.integers(0, 2, size=(nblocks, 2, 128), dtype=np.int8))
    for bad in ((3, 32), (4, 128), (1, 16), (2, 96)):
        with pytest.raises(ValueError, match="launch"):
            trd.butterfly_apply((x,), mk, (1,), bl, launch=bad)
        with pytest.raises(ValueError, match="launch"):
            trd.bigshift_apply((x,), smk, bl, bl, launch=bad)


@pytest.mark.parametrize("slots", [4, 2, 1])
def test_bigshift_thread_emulation(slots):
    """K6's thread: the mask bytes of its `slots` slots first, then the far
    block's words alone (all set), its own alone (none) or both, selected
    (mixed), emulated in numpy on masks with runs and isolated bytes; equal
    to the plain version bit for bit, every layout block read through
    _phys_index."""
    rng = np.random.default_rng(slots)
    bl, nblocks, d = 256, 8, 3 * 256
    x = rng.standard_normal(nblocks * bl).astype(np.float32)
    bits = rng.random(nblocks * bl) < 0.3
    runs = np.repeat(rng.random(nblocks * bl // 16) < 0.4, 16)
    mask = (bits | runs).astype(np.int8) * rng.integers(1, 128, size=nblocks * bl).astype(np.int8)
    layout = (2, 0, 1)
    want = trd.bigshift_apply_plain(
        (torch.as_tensor(x).view(-1, 128),), torch.as_tensor(mask).view(nblocks, 2, 128),
        d, bl, layout=layout)[0].numpy().reshape(-1)
    phys = trd._phys_index(nblocks, layout, "cpu").numpy()
    db = d // bl
    got = np.empty_like(x)
    kinds = set()
    for b in range(nblocks):
        far0 = phys[(b + nblocks - db) % nblocks] * bl
        self0 = phys[b] * bl
        for off in range(0, bl, slots):
            mw = mask[b * bl + off:b * bl + off + slots] != 0
            far = x[far0 + off:far0 + off + slots]
            own = x[self0 + off:self0 + off + slots]
            if mw.all():
                q, kind = far, "all"
            elif not mw.any():
                q, kind = own, "none"
            else:
                q, kind = np.where(mw, far, own), "mixed"
            kinds.add(kind)
            got[b * bl + off:b * bl + off + slots] = q
    assert got.view(np.int32).tolist() == want.view(np.int32).tolist()
    assert kinds == ({"all", "none"} if slots == 1 else {"all", "none", "mixed"})
