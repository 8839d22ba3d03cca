"""lilac_tpu_torch adjoint routing against the JAX package, on the CPU.

The adjoint appliers run a network's stages in reverse order; shift stages
become add-merges, summed stage by stage in the same order in both packages
with every step rounded on its own, so each plain version equals its Pallas
counterpart (interpret mode) bit for bit, also for a df64 (hi, lo) pair.
Whole reversed schedules are held against the dense transpose of the gather
they encode. Transpose products are compared on the SAME plan, built by the
JAX package and carried across by convert_reference, with the tolerance
stated per test. Sizes are small (bl = 256, a few thousand slots) so that
the interpret-mode calls stay cheap.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
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

# The tensors of these tests are tiny and PyTorch's CPU thread pool gains
# nothing on them; when several test processes share the cores, every process
# spinning a pool of its own makes the eager op chains (an NPB class S run is
# some 10^5 small ops) tens of times slower. One thread per process, set when
# the module is imported so that it holds for the whole test process.
torch.set_num_threads(1)

BL = 256
_NB, _R = 8, BL // 128

# one pass of each kind over 8 blocks of 256 slots: (meta, mask shape without
# the net axis, mask bits in use). "inner_mixed" holds shift and shiftl stages
# too, which only the plain inner adjoint serves (compile_hier builds none).
_PASSES = {
    "inner": (("inner", ("xor",) * 10, (128, 1, 64, 2, 32, 4, 16, 8, 1, 128)),
              (_NB, 2, _R, 128), 8),
    "inner_mixed": (("inner",
                     ("xor", "shift", "shiftl", "shift", "xor", "shiftl", "shift",
                      "xor", "shiftl"),
                     (64, 1, 2, 128, 128, 128, 37, 1, 100)),
                    (_NB, 2, _R, 128), 8),
    "butterfly": (("butterfly", (2, 0)), (_NB // 4, 4 * _R, 128), 2),
    "window": (("window", (1, 2, 4, 8, 16, 32, 64, 100)), (_NB, 2 * _R, 128), 8),
    "bigshift": (("bigshift", 3 * BL), (_NB, _R, 128), 1),
}
_JAX_BT = {"inner": jrd.routed_apply_sliced_bt, "inner_mixed": jrd.routed_apply_sliced_bt,
           "butterfly": jrd.butterfly_apply_bt, "window": jrd.window_shift_apply_bt,
           "bigshift": jrd.bigshift_apply_bt}
_TORCH_BT = {
    "inner": (trd.routed_apply_sliced_bt, trd.routed_apply_sliced_bt_plain),
    "inner_mixed": (trd.routed_apply_sliced_bt, trd.routed_apply_sliced_bt_plain),
    "butterfly": (trd.butterfly_apply_bt, trd.butterfly_apply_bt_plain),
    "window": (trd.window_shift_apply_bt, trd.window_shift_apply_bt_plain),
    "bigshift": (trd.bigshift_apply_bt, trd.bigshift_apply_bt_plain),
}
# value format: (numpy dtype, planes, dfpair)
_FORMATS = {"f32": (np.float32, 1, False), "f64": (np.float64, 1, False),
            "df64": (np.float32, 2, True)}


def _df_planes(rng, shape):
    """An f32 (hi, lo) pair with lo well below hi's last bit, and signed
    zeros among the values."""
    v = rng.standard_normal(shape) * np.exp(rng.uniform(-6, 6, shape))
    v[rng.random(shape) < 0.05] = -0.0
    s = tdf.split_f64_np(v)
    return [np.ascontiguousarray(s[..., 0]), np.ascontiguousarray(s[..., 1])]


def _planes(rng, fmt, shape):
    dtype, nplanes, dfpair = _FORMATS[fmt]
    if dfpair:
        return _df_planes(rng, shape)
    return [rng.standard_normal(shape).astype(dtype) for _ in range(nplanes)]


def _call_bt(fn, meta, planes, masks, layout, dfpair, **kw):
    if meta[0] == "butterfly":  # a pure permutation: no dfpair
        return fn(planes, masks, meta[1], BL, layout=layout, **kw)
    if meta[0] == "inner":
        return fn(planes, masks, meta[1], meta[2], dfpair=dfpair, layout=layout,
                  **kw), None
    return fn(planes, masks, meta[1], BL, dfpair=dfpair, layout=layout, **kw), None


@pytest.mark.parametrize("fmt,N,layout", [
    ("f32", 2, (1, 2, 0)), ("f64", 1, None), ("df64", 2, None), ("df64", 1, (1, 2, 0)),
], ids=["f32-batched-scrambled", "f64-one_net-identity", "df64-batched-identity",
        "df64-one_net-scrambled"])
@pytest.mark.parametrize("kind", list(_PASSES))
def test_adjoint_pass_matches_pallas_interpret(kind, fmt, N, layout):
    """Random masks: the wrapper (which takes the plain version for CPU
    tensors) and the plain version itself equal the Pallas adjoint kernel
    run in interpret mode, exactly (max abs difference 0, signed zeros and
    the lo words of a df64 pair included)."""
    meta, mshape, bits = _PASSES[kind]
    rng = np.random.default_rng(41)
    m = _NB * BL
    masks = rng.integers(0, 1 << bits, size=(N,) + mshape, dtype=np.uint8).view(np.int8)
    xs = _planes(rng, fmt, (N, m // 128, 128))
    dfpair = _FORMATS[fmt][2]
    want, want_layout = _call_bt(_JAX_BT[kind], meta, [jnp.asarray(x) for x in xs],
                                 jnp.asarray(masks), layout, dfpair, interpret=True)
    tx, tm = [torch.as_tensor(x) for x in xs], torch.as_tensor(masks)
    wrapper, plain = _TORCH_BT[kind]
    for fn in (wrapper, plain):
        got, got_layout = _call_bt(fn, meta, tx, tm, layout, dfpair)
        assert got_layout == want_layout
        assert len(got) == len(want) == len(xs)
        for w, g in zip(want, got):
            assert g.shape == (N, m // 128, 128)
            w = np.asarray(w)
            assert g.numpy().dtype == w.dtype
            np.testing.assert_array_equal(w, g.numpy())
            np.testing.assert_array_equal(np.signbit(w), np.signbit(g.numpy()))
    assert wrapper.launches == 0  # only a launch of the CUDA kernel counts


def _idx(seed, B, m, ncol):
    return np.random.default_rng(seed).integers(0, ncol, size=(B, m))


def _gather_transpose(idx, u, ncol):
    """(G^T u)[b, j] = sum of u[b, k] over the slots k with idx[b, k] = j."""
    out = np.zeros((idx.shape[0], ncol))
    for b in range(idx.shape[0]):
        np.add.at(out[b], idx[b], u[b].astype(np.float64))
    return out


@pytest.mark.parametrize("fmt", list(_FORMATS))
@pytest.mark.parametrize("mode", ["benes", "monotone"])
def test_routed_apply_t_matches_pallas_interpret(mode, fmt):
    """K11's plain version on a Benes (xor only) and a monotone (xor, shift,
    shiftl) network: equal to the Pallas kernel in interpret mode exactly,
    and to the transpose of the gather the network encodes (f32: 1e-5
    relative to sum|u| per column, the merges' rounding; f64 and the df64
    pair: 1e-12)."""
    B, m, ncol = 2, 1024, 700
    idx = _idx(42, B, m, ncol)
    net = trn.build_gather_network(idx, ncol, m, mode=mode)
    if mode == "monotone":
        assert set(net.kinds) == {"xor", "shift", "shiftl"}
    masks = trd.masks_packed(net.masks)
    rng = np.random.default_rng(43)
    xs = _planes(rng, fmt, (B, m // 128, 128))
    dfpair = _FORMATS[fmt][2]
    want = jrd.routed_apply_t([jnp.asarray(x) for x in xs], jnp.asarray(masks),
                              net.kinds, net.dists, dfpair=dfpair, interpret=True)
    tx, tm = [torch.as_tensor(x) for x in xs], torch.as_tensor(masks)
    for fn in (trd.routed_apply_t, trd.routed_apply_t_plain):
        got = fn(tx, tm, net.kinds, net.dists, dfpair=dfpair)
        for w, g in zip(want, got):
            assert g.shape == (B, m // 128, 128)
            np.testing.assert_array_equal(np.asarray(w), g.numpy())
    assert trd.routed_apply_t.launches == 0
    u = sum(x.astype(np.float64) for x in xs).reshape(B, m)
    y = sum(g.numpy().astype(np.float64) for g in got).reshape(B, m)
    ref = _gather_transpose(idx, u, ncol)
    scale = _gather_transpose(idx, np.abs(u), ncol)
    tol = 1e-5 if fmt == "f32" else 1e-12
    assert (np.abs(y[:, :ncol] - ref) <= tol * scale + 1e-300).all()
    # slots beyond the columns receive nothing
    assert not y[:, ncol:].any()


def _schedule(seed, m, ncol, dense, gmax, B=1):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, ncol, size=(B, m))
    for b in range(B):
        idx[b, rng.choice(m, size=dense, replace=False)] = 3 + b
    net = trn.build_gather_network(idx, ncol, m, drop_empty=False)
    per_net = [trd.compile_hier(net.kinds, net.dists, net.masks[:, b, :], BL, gmax=gmax)
               for b in range(B)]
    metas = tuple(p[:-1] for p in per_net[0])
    assert all(tuple(p[:-1] for p in pn) == metas for pn in per_net)
    stacked = tuple(np.stack([pn[j][-1] for pn in per_net]) for j in range(len(metas)))
    return idx, net, metas, stacked


@pytest.mark.parametrize("gmax", [1, 2, 3])
def test_hier_apply_batched_t_is_dense_transpose(gmax):
    """hier_apply_batched_t realises G^T for the forward's own pass masks,
    against the dense operator of the network (700 slots ask for one column:
    window and bigshift passes; 8 blocks: butterflies). f64 planes to 1e-12,
    an f32 plane to 1e-5 relative to |G|^T |u|; at gmax 2 also equal to the
    JAX package's reversed schedule in interpret mode, exactly."""
    m = 2048
    idx, net, metas, stacked = _schedule(44, m, 1500, 700, gmax)
    assert {mt[0] for mt in metas} == {"inner", "butterfly", "window", "bigshift"}
    # the one net's masks broadcast over the m basis vectors: row j = G e_j
    G = net.apply_host(np.eye(m, dtype=np.float32)).T
    assert np.array_equal(G.argmax(axis=1), idx[0]) and (G.sum(axis=1) == 1).all()
    rng = np.random.default_rng(45)
    u = rng.standard_normal(m)
    masks = tuple(torch.as_tensor(mk) for mk in stacked)
    for dtype, tol in ((np.float64, 1e-12), (np.float32, 1e-5)):
        ud = u.astype(dtype)
        (out,) = trd.hier_apply_batched_t(
            (torch.as_tensor(ud).view(1, -1, 128),), metas, masks, BL)
        assert out.shape == (1, m // 128, 128)
        want = G.T.astype(np.float64) @ ud.astype(np.float64)
        scale = np.abs(G.T).astype(np.float64) @ np.abs(ud).astype(np.float64)
        assert (np.abs(out.numpy().reshape(m) - want) <= tol * scale + 1e-300).all()
    if gmax == 2:
        pair = _df_planes(rng, (1, m // 128, 128))
        want = jrd.hier_apply_batched_t(
            tuple(jnp.asarray(p) for p in pair), metas,
            tuple(jnp.asarray(mk) for mk in stacked), BL, dfpair=True, interpret=True)
        got = trd.hier_apply_batched_t(
            tuple(torch.as_tensor(p) for p in pair), metas, masks, BL, dfpair=True)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(np.asarray(w), g.numpy())


def test_hier_adjoint_consecutive_butterflies():
    """Layout chaining across CONSECUTIVE butterfly adjoints (more outer bits
    than gmax): m / bl = 32 gives g = 3 and g = 2 passes back to back on each
    side, as the large NPB classes have. <G x, u> = <x, G^T u> in f64
    (1e-12), and G^T against the gather's transpose on the used slots, for
    two nets at once."""
    B, m, ncol = 2, 1 << 13, 2000
    idx, net, metas, stacked = _schedule(46, m, ncol, 0, 3, B=B)
    seq = [mt[0] for mt in metas]
    assert any(a == b == "butterfly" for a, b in zip(seq, seq[1:])), seq
    masks = tuple(torch.as_tensor(mk) for mk in stacked)
    rng = np.random.default_rng(47)
    x = rng.standard_normal(m)
    u = rng.standard_normal((B, m))
    (gx,) = trd.hier_apply_batched((torch.as_tensor(x).view(-1, 128),), metas, masks, BL)
    (gtu,) = trd.hier_apply_batched_t(
        (torch.as_tensor(u).view(B, -1, 128),), metas, masks, BL)
    lhs = (gx.numpy().reshape(B, m) * u).sum(axis=1)
    rhs = gtu.numpy().reshape(B, m) @ x
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12)
    want = _gather_transpose(idx, u, ncol)
    np.testing.assert_allclose(gtu.numpy().reshape(B, m)[:, :ncol], want,
                               rtol=1e-12, atol=1e-12)
    # the same through an (hi, lo) pair with compensated merges
    s = tdf.split_f64_np(u)
    oh, ol = trd.hier_apply_batched_t(
        tuple(torch.as_tensor(np.ascontiguousarray(s[..., k])).view(B, -1, 128)
              for k in (0, 1)), metas, masks, BL, dfpair=True)
    got = oh.numpy().astype(np.float64) + ol.numpy().astype(np.float64)
    scale = _gather_transpose(idx, np.abs(u), ncol)
    assert (np.abs(got.reshape(B, m)[:, :ncol] - want) <= 4e-14 * scale).all()


def test_adjoint_appliers_reject_bad_arguments():
    meta, mshape, _ = _PASSES["window"]
    masks = torch.zeros((2,) + mshape, dtype=torch.int8)
    x = torch.zeros(2, _NB * _R, 128)
    with pytest.raises(ValueError, match="per-net"):
        trd.window_shift_apply_bt([x[0]], masks, meta[1], BL)  # a shared plane
    with pytest.raises(ValueError):
        trd.window_shift_apply_bt([x], masks[0], meta[1], BL)  # no net axis
    with pytest.raises(ValueError):
        trd.window_shift_apply_bt([x], masks, (200, 100), BL)
    with pytest.raises(ValueError):
        trd.bigshift_apply_bt(
            [x], torch.zeros((2,) + _PASSES["bigshift"][1], dtype=torch.int8), BL + 1, BL)
    with pytest.raises(ValueError, match="per-net"):
        trd.butterfly_apply_bt(
            [x[0]], torch.zeros((2,) + _PASSES["butterfly"][1], dtype=torch.int8),
            (2, 0), BL)
    net_masks = torch.zeros((2, 1, 8, 128), dtype=torch.int8)
    with pytest.raises(ValueError):  # the single-table adjoint takes [B, m] planes
        trd.routed_apply_t([torch.zeros(8, 128)], net_masks, ("xor",), (4,))


def test_adjoint_window_shared_memory():
    """The adjoint window keeps bl + sum(d) slots and their mask bytes on
    chip; one plan serves both directions, so a pass is sized by the larger
    need. The derived default block fits the worst window of a df64 pair; a
    block twice as long fits only with short shifts, and is refused at load
    otherwise."""
    bl = trd.default_hier_bl()
    worst = (("window", (bl - 1,)),)
    assert trd.pass_smem_bytes(worst[0], bl, 2, 4) == 2 * bl * 9
    assert trd.pass_smem_bytes(("window", (1, 2, 4, 8)), bl, 2, 4) == (bl + 16) * 9
    trd.check_smem_feasible(worst, bl, 2, 4)
    trd.check_smem_feasible((("window", (1, 2, 4, 8)),), 2 * bl, 2, 4)
    with pytest.raises(ValueError, match="'window' needs"):
        trd.check_smem_feasible((("window", (2 * bl - 1,)),), 2 * bl, 2, 4)


def _csr(seed, n, ncol, kmin, kmax, dense_rows=0):
    rng = np.random.default_rng(seed)
    counts = rng.integers(kmin, kmax + 1, size=n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    indices = rng.integers(0, ncol, size=int(indptr[-1]))
    indices[indptr[rng.choice(n, size=dense_rows, replace=False)]] = 7
    return indptr, indices, rng.standard_normal(len(indices)), (n, ncol)


def _transpose_product(indptr, indices, data, shape, u):
    """(A^T u, |A|^T |u|) in f64 by scipy (copies: abs() merges duplicates)."""
    A = sp.csr_matrix((data.copy(), indices.copy(), indptr.copy()), shape=shape)
    return A.T @ u, abs(A).T @ np.abs(u)


@pytest.mark.parametrize("sort_rows", [True, False], ids=["sorted", "natural"])
@pytest.mark.parametrize("dtype", ["f32", "df64"])
def test_routed_spmv_adj_t_matches_reference_on_same_plan(dtype, sort_rows):
    """Single-table transpose product on a JAX-built monotone plan (sorted
    rows: the scatter through inv_perm runs). f32: the merges are identical,
    the sum over the nets differs by order, 1e-6 * sum|v u|; df64:
    4e-14 * sum|v u|; both also against scipy's A^T u."""
    indptr, indices, data, shape = _csr(48, 300, 260, 1, 9)
    u = np.random.default_rng(49).standard_normal(shape[0])
    want, scale = _transpose_product(indptr, indices, data, shape, u)
    J = jrs.build_routed_csr(indptr, indices, data, shape, dtype=dtype, m=1024,
                             sort_rows=sort_rows)
    assert (J.inv_perm is not None) == sort_rows and len(J.chunks) > 1
    T = cr.routed_mat_from_arrays(
        np.asarray(J.masks), np.asarray(J.vals), J.kinds, J.dists, J.chunks,
        None if J.inv_perm is None else np.asarray(J.inv_perm),
        J.shape, J.m, J.colmajor, device="cpu")
    if dtype == "df64":
        yj = jdf.to_f64(jrs.routed_spmv_adj_t_df(J, jdf.from_f64(u), interpret=True))
        yt = tdf.to_f64(trs.routed_spmv_adj_t_df(T, tdf.from_f64(u, device="cpu")))
        tol = 4e-14
    else:
        yj = np.asarray(jrs.routed_spmv_adj_t(
            J, jnp.asarray(u, jnp.float32), interpret=True), np.float64)
        yt = trs.routed_spmv_adj_t(T, torch.as_tensor(u, dtype=torch.float32)).numpy()
        tol = 1e-6
    assert yt.shape == yj.shape == (shape[1],)
    assert (np.abs(yt - yj) <= tol * scale + 1e-300).all()
    assert (np.abs(yt - want) <= tol * scale + 1e-300).all()


def _one_net_a_group(monkeypatch):
    """Pack every net as a group of its own: the split _group_cap makes on a
    card whose memory is short, so every pass launches net by net."""
    monkeypatch.setattr(trs, "_group_cap", lambda M, device: 1)


def _carry_hier(M):
    return cr.hier_mat_from_arrays(
        [[np.asarray(mk) for mk in net.pass_masks] for net in M.nets],
        [net.pass_meta for net in M.nets],
        [np.asarray(v) for v in M.vals],
        None if M.unperm is None else [np.asarray(mk) for mk in M.unperm.pass_masks],
        None if M.unperm is None else M.unperm.pass_meta,
        M.chunks, M.shape, M.m, M.m_out, M.bl, M.n_nz, M.colmajor,
        device="cpu")


@pytest.mark.parametrize("pack", [True, False], ids=["packed", "net_by_net"])
@pytest.mark.parametrize("dtype", ["f32", "df64"])
def test_routed_hier_spmv_adj_t_matches_reference_on_same_plan(dtype, pack, monkeypatch):
    """Hierarchical transpose product on a JAX-built plan, the nets packed
    in groups or one net a group (against the JAX package's net by net
    product): unsorted rows (the un-permute network runs in reverse too), a
    dense column (bigshift adjoints), several nets (the cross-net sum).
    Tolerances as for the single table."""
    indptr, indices, data, shape = _csr(50, 800, 800, 1, 4, dense_rows=700)
    u = np.random.default_rng(51).standard_normal(shape[0])
    want, scale = _transpose_product(indptr, indices, data, shape, u)
    J = jrs.build_routed_csr_hier(indptr, indices, data, shape, dtype=dtype, bl=BL)
    assert J.unperm is not None and len(J.nets) > 1
    assert any(mt[0] == "bigshift" for net in J.nets for mt in net.pass_meta)
    if not pack:
        _one_net_a_group(monkeypatch)
    T = _carry_hier(J)
    assert isinstance(T, trs.RoutedMatHierP)
    if not pack:
        assert [g.net_ids for g in T.groups] == [(i,) for i in range(len(J.nets))]
    Jr = jrs.pack_hier(J) if pack else J
    if dtype == "df64":
        yj = jdf.to_f64(jrs.routed_hier_spmv_adj_t_df(Jr, jdf.from_f64(u), interpret=True))
        yt = tdf.to_f64(trs.routed_hier_spmv_adj_t_df(T, tdf.from_f64(u, device="cpu")))
        tol = 4e-14
    else:
        yj = np.asarray(jrs.routed_hier_spmv_adj_t(
            Jr, jnp.asarray(u, jnp.float32), interpret=True), np.float64)
        yt = trs.routed_hier_spmv_adj_t(T, torch.as_tensor(u, dtype=torch.float32)).numpy()
        tol = 1e-6
    assert yt.shape == yj.shape == (shape[1],)
    assert (np.abs(yt - yj) <= tol * scale + 1e-300).all()
    assert (np.abs(yt - want) <= tol * scale + 1e-300).all()


def test_hier_adjoint_of_sorted_rows_and_host_plan(monkeypatch):
    """Rows that come length-sorted need no un-permute: its adjoint is a cut,
    the nets packed in groups or one net a group. A plan still staged on
    the host is refused."""
    n = 500
    counts = np.sort(np.random.default_rng(52).integers(1, 6, size=n))[::-1]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    rng = np.random.default_rng(53)
    indices = rng.integers(0, n, size=int(indptr[-1]))
    data = rng.standard_normal(len(indices))
    M = trs.build_routed_csr_hier(indptr, indices, data, (n, n), dtype="f64", bl=BL)
    assert M.unperm is None
    u = rng.standard_normal(n)
    with pytest.raises(TypeError, match="staged on the host"):
        trs.routed_hier_spmv_adj_t(M, torch.as_tensor(u))
    want, scale = _transpose_product(indptr, indices, data, (n, n), u)
    for pack in ("1", "0"):
        if pack == "0":
            _one_net_a_group(monkeypatch)
        P = trs.pack_hier(M, "cpu")
        got = trs.routed_hier_spmv_adj_t(P, torch.as_tensor(u)).numpy()
        assert (np.abs(got - want) <= 1e-13 * scale + 1e-300).all()
    assert len(P.groups) == len(M.nets)


@pytest.fixture
def routed_class_s(tmp_path, monkeypatch):
    monkeypatch.setenv("LILAC_DATA_DIR", str(tmp_path))
    monkeypatch.setenv("LILAC_FACTORED_SEGMODE", "routed")
    return tmp_path


def _force_hier(monkeypatch):
    """Class S (na = 1400) through hierarchical plans: the single-table limit
    lowered to 1024 and a forced block of 256 slots (m = 2048: 8 blocks)."""
    monkeypatch.setenv("LILAC_HIER_BL", str(BL))
    monkeypatch.setattr(trs, "SINGLE_TABLE_MAX", 1024)


@pytest.mark.parametrize("layout", ["hier_packed", "hier_net_by_net", "single_table"])
def test_factored_adj_matches_plan_and_gather(layout, routed_class_s, monkeypatch):
    """The slice as a whole: with factored_vt=adj the operator holds V's plan
    alone (no VT file is written, a second build loads V's), and its df64
    product equals factored_vt=plan's and the gather operator's to 1e-13
    relative."""
    if layout != "single_table":
        _force_hier(monkeypatch)
        if layout == "hier_net_by_net":
            _one_net_a_group(monkeypatch)
    else:
        monkeypatch.setenv("LILAC_FACTORED_VT", "adj")  # auto is plan for one table
    Aa, nnz = tfac.build_factored("S", dtype="df64", device="cpu")
    kind = trs.RoutedMat if layout == "single_table" else trs.RoutedMatHierP
    assert Aa.VT is None and isinstance(Aa.V, kind)
    if layout == "hier_net_by_net":
        assert all(len(g.net_ids) == 1 for g in Aa.V.groups)
    names = sorted(f.name for f in routed_class_s.iterdir())
    assert len(names) == 2 and not any("_VT" in f for f in names), names
    monkeypatch.setattr(
        "lilac_tpu_torch.generate.npb._generate_triples",
        lambda cls: pytest.fail("cache hit regenerated triples"))
    A2, nnz2 = tfac.build_factored("S", dtype="df64", device="cpu")
    assert nnz2 == nnz and A2.VT is None and isinstance(A2.V, kind)
    monkeypatch.undo()

    monkeypatch.setenv("LILAC_DATA_DIR", str(routed_class_s))
    monkeypatch.setenv("LILAC_FACTORED_SEGMODE", "routed")
    monkeypatch.setenv("LILAC_FACTORED_VT", "plan")
    if layout != "single_table":
        _force_hier(monkeypatch)
    Ap, _ = tfac.build_factored("S", dtype="df64", device="cpu")
    assert Ap.VT is not None
    monkeypatch.setenv("LILAC_FACTORED_SEGMODE", "single")
    G, _ = tfac.build_factored("S", dtype="df64", device="cpu")
    # adj and plan share the relabelled (sigma) space: any vector compares
    x = np.random.default_rng(54).standard_normal(1400)
    xd = tdf.from_f64(x, device="cpu")
    yp = tdf.to_f64(tfac.factored_spmv_df(Ap, xd))
    for A in (Aa, A2):
        ya = tdf.to_f64(tfac.factored_spmv_df(A, xd))
        assert np.abs(ya - yp).max() <= 1e-13 * np.abs(yp).max()
    # the gather operator lives in the natural space: x = ones, sorted y
    ones = tdf.from_f64(np.ones(1400), device="cpu")
    ya = np.sort(tdf.to_f64(tfac.factored_spmv_df(Aa, ones)))
    yg = np.sort(tdf.to_f64(tfac.factored_spmv_df(G, ones)))
    assert np.abs(ya - yg).max() <= 1e-13 * np.abs(yg).max()
    # plain floats take the same route
    Af, _ = tfac.build_factored("S", dtype="f64", device="cpu")  # vt = plan
    monkeypatch.setenv("LILAC_FACTORED_SEGMODE", "routed")
    monkeypatch.setenv("LILAC_FACTORED_VT", "adj")
    Aaf, _ = tfac.build_factored("S", dtype="f64", device="cpu")
    assert Aaf.VT is None
    yf = np.sort(tfac.factored_spmv(Af, torch.ones(1400, dtype=torch.float64)).numpy())
    yaf = np.sort(tfac.factored_spmv(Aaf, torch.ones(1400, dtype=torch.float64)).numpy())
    assert np.abs(yaf - yf).max() <= 1e-13 * np.abs(yf).max()


def test_npb_class_s_verifies_in_adj(routed_class_s, monkeypatch):
    """NPB class S in df64 on the CPU with V^T through V's single-table plan
    in reverse: all 15 outer steps, zeta verified to 1e-10."""
    monkeypatch.setenv("LILAC_FACTORED_VT", "adj")
    r = trun.run("S", dtype="df64", device="cpu")
    assert r.kernel == "factored_routed_df" and r.factored_vt == "adj"
    assert r.verified and r.rel_err <= 1e-10


def test_npb_class_s_through_one_hier_plan(routed_class_s, monkeypatch):
    """NPB class S through ONE hierarchical plan for both directions (auto
    resolves to adj beyond a single table), cut to 4 outer steps: the zeta
    history agrees with the native-f64 gather operator's to 1e-12 relative."""
    _force_hier(monkeypatch)
    r = trun.run("S", dtype="df64", device="cpu", niter=4)
    assert r.kernel == "factored_routed_df" and r.factored_vt == "adj" and r.niter == 4
    monkeypatch.setenv("LILAC_FACTORED_SEGMODE", "single")
    g = trun.run("S", dtype="f64", device="cpu", niter=4)
    assert g.kernel == "factored_gather" and g.factored_vt == "plan"
    assert np.abs(r.zeta_history - g.zeta_history).max() <= 1e-12 * abs(g.zeta)
