"""K2 over a whole product: dfmulred_chunks and its chunk tables, on the CPU.

The kernel of csrc/dfmulred.cu serves every chunk of a product in one grid:
a ChunkTable lists, once per container, each chunk's slots and output rows
and cuts the chunks into thread blocks of K2_ROWS rows; the kernel writes
straight into the product's concatenated output planes. These tests hold
the tables the single-table (RoutedMat) and hierarchical (packed HierGroup
and net-by-net) containers get against the per-chunk slices the earlier
one-launch-a-chunk loops took, emulate the kernel's thread blocks with
numpy (the row -> chunk mapping and the dot2 sum in f32), and hold the
products through the new path bit for bit to the per-chunk path and to the
JAX package's within 4e-14 * sum|v x| (tests/test_torch_dfmulred.py's
tolerance: the JAX CPU path sums by another tree).
"""

import numpy as np
import pytest
import torch

from lilac_tpu.kernels import routed_spmv as jrs
from lilac_tpu.ops import dfloat as jdf
from lilac_tpu_torch import convert_reference as cr
from lilac_tpu_torch.kernels import dfmulred as tdk
from lilac_tpu_torch.kernels import routed as trd
from lilac_tpu_torch.kernels import routed_spmv as trs
from lilac_tpu_torch.ops import dfloat as tdf
from lilac_tpu_torch.workloads import npb_cg as trun

torch.set_num_threads(1)

BL = 256


def _csr(seed, n, ncol, kmin, kmax, dense_rows=0):
    rng = np.random.default_rng(seed)
    counts = rng.integers(kmin, kmax + 1, size=n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    indices = rng.integers(0, ncol, size=int(indptr[-1]))
    indices[indptr[rng.choice(n, size=dense_rows, replace=False)]] = 7
    return indptr, indices, rng.standard_normal(len(indices)), (n, ncol)


def _scale(indptr, indices, data, shape, x):
    """sum |v x| per row, in f64."""
    rows = np.repeat(np.arange(shape[0]), np.diff(indptr))
    s = np.zeros(shape[0])
    np.add.at(s, rows, np.abs(data * x[indices]))
    return s


def _per_chunk(vh, vl, xh, xl, chunks):
    """The earlier loops: one dfmulred_plain a (slot0, rows, K) chunk of the
    flat planes, the row sums concatenated."""
    hs, ls = [], []
    for s0, rows, K in chunks:
        sl = slice(s0, s0 + rows * K)
        h, l_ = tdk.dfmulred_plain(*(t[sl].view(K, rows) for t in (vh, vl, xh, xl)))
        hs.append(h)
        ls.append(l_)
    return torch.cat(hs), torch.cat(ls)


def _bits_equal(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


# ---- the kernel's thread blocks in numpy ------------------------------------

def _split(a):
    t = np.float32(4097.0) * a
    hi = t - (t - a)
    return hi, a - hi


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _emulate(vh, vl, xh, xl, table):
    """csrc/dfmulred.cu's grid over table.blocks, a thread a row, every f32
    operation in the kernel's order; checks that each output row is written
    once, by a thread of a block of at most K2_ROWS rows."""
    vh, vl, xh, xl = (np.asarray(t, dtype=np.float32) for t in (vh, vl, xh, xl))
    yh = np.zeros(table.rows, np.float32)
    yl = np.zeros(table.rows, np.float32)
    written = np.zeros(table.rows, np.int64)
    for v0, y0, R, kn in table.blocks:
        K, n = int(kn) >> 32, int(kn) & 0xFFFFFFFF
        assert 1 <= n <= tdk.K2_ROWS
        t = np.arange(n)
        s = np.zeros(n, np.float32)
        c = np.zeros(n, np.float32)
        for k in range(K):
            i = v0 + t + k * R
            a_h, a_l, b_h, b_l = vh[i], vl[i], xh[i], xl[i]
            p = a_h * b_h
            ahi, alo = _split(a_h)
            bhi, blo = _split(b_h)
            ep = ahi * bhi - p
            ep = ep + ahi * blo
            ep = ep + alo * bhi
            ep = ep + alo * blo
            ep = ep + (a_h * b_l + a_l * b_h)
            s, es = _two_sum(s, p)
            c = c + (es + ep)
        hi, lo = _two_sum(s, c)
        yh[y0 + t], yl[y0 + t] = hi, lo
        written[y0 + t] += 1
    assert (written == 1).all()
    return yh, yl


def _random_spec(rng, nchunks, gap=True):
    """(slot0, rows, K, row0) chunks with gaps between them, rows from 1 to
    a few thread blocks, K from 0 to 40."""
    spec, slot, row0 = [], 0, 0
    for _ in range(nchunks):
        rows = int(rng.integers(1, 3 * tdk.K2_ROWS))
        K = int(rng.integers(0, 41))
        slot += int(rng.integers(0, 50)) if gap else 0
        spec.append((slot, rows, K, row0))
        slot += rows * K
        row0 += rows
    return spec, slot


def _df_planes(rng, n, interleaved):
    v = rng.standard_normal(n) * np.exp(rng.uniform(-8, 8, n))
    v[rng.random(n) < 0.03] = -0.0
    s = torch.as_tensor(tdf.split_f64_np(v))
    if interleaved:  # the [.., 2] value array, read in place (stride 2)
        return s[:, 0], s[:, 1]
    return s[:, 0].contiguous(), s[:, 1].contiguous()


@pytest.mark.parametrize("interleaved", [True, False], ids=["interleaved", "planes"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chunks_plain_and_emulation_match_per_chunk(seed, interleaved):
    """dfmulred_chunks (the plain version, on CPU tensors) equals the
    per-chunk dfmulred_plain concatenated, bit for bit, and so does the
    numpy emulation of the kernel's thread blocks."""
    rng = np.random.default_rng(seed)
    spec, slots = _random_spec(rng, 1 + 4 * seed)
    table = tdk.ChunkTable(spec)
    vh, vl = _df_planes(rng, slots, interleaved)
    xh, xl = _df_planes(rng, slots, False)
    want = _per_chunk(vh, vl, xh, xl, [(a, r, k) for a, r, k, _ in spec])
    for got in (tdk.dfmulred_chunks(vh, vl, xh, xl, table),
                tdk.dfmulred_chunks_plain(vh, vl, xh, xl, table),
                tuple(torch.as_tensor(y) for y in _emulate(vh, vl, xh, xl, table))):
        assert _bits_equal(got[0], want[0]) and _bits_equal(got[1], want[1])


def test_chunks_write_into_shared_outputs():
    """Two tables over disjoint rows write one pair of output planes (a
    product served in several launches); bad planes and outputs raise."""
    rng = np.random.default_rng(5)
    spec, slots = _random_spec(rng, 6, gap=False)
    first = tdk.ChunkTable(spec[:3])
    second = tdk.ChunkTable(spec[3:])
    assert (first.rows, second.rows) == (spec[2][3] + spec[2][1], spec[5][3] + spec[5][1])
    vh, vl = _df_planes(rng, slots, True)
    xh, xl = _df_planes(rng, slots, False)
    out = (torch.full((second.rows,), np.nan), torch.full((second.rows,), np.nan))
    for t in (first, second):
        got = tdk.dfmulred_chunks(vh, vl, xh, xl, t, out)
        assert got[0] is out[0] and got[1] is out[1]
    want = tdk.dfmulred_chunks(vh, vl, xh, xl, tdk.ChunkTable(spec))
    assert _bits_equal(out[0], want[0]) and _bits_equal(out[1], want[1])
    with pytest.raises(ValueError, match="slots"):
        tdk.dfmulred_chunks(vh[:-1], vl[:-1], xh, xl, second)
    with pytest.raises(ValueError, match="output planes"):
        tdk.dfmulred_chunks(vh, vl, xh, xl, second, (out[0][:-1], out[1]))
    with pytest.raises(ValueError, match="bad chunk"):
        tdk.ChunkTable([(0, 4, -1, 0)])


def test_table_blocks_cover_each_chunk():
    """Each chunk is cut into ceil(rows / K2_ROWS) thread blocks of its own
    K and term stride, covering its rows once in order."""
    spec = [(10, 1, 3, 0), (13, 256, 2, 1), (600, 257, 0, 257), (600, 700, 5, 514)]
    table = tdk.ChunkTable(spec)
    blocks = table.blocks
    assert blocks.dtype == np.int64 and blocks.shape == (1 + 1 + 2 + 3, 4)
    j = 0
    for slot0, rows, K, row0 in spec:
        for r0 in range(0, rows, tdk.K2_ROWS):
            v0, y0, R, kn = blocks[j]
            assert (v0, y0, R) == (slot0 + r0, row0 + r0, rows)
            assert kn == (K << 32) | min(tdk.K2_ROWS, rows - r0)
            j += 1
    assert table.rows == 1214 and table.slots == 600 + 700 * 5
    assert tdk.chunk_list_table(((0, 4, 2), (8, 3, 1))).spec == ((0, 4, 2, 0), (8, 3, 1, 4))
    assert tdk.chunk_list_table(((0, 4, 2),)) is tdk.chunk_list_table(((0, 4, 2),))
    assert table.blocks_on("cpu") is table.blocks_on("cpu")


# ---- the containers' tables and products ------------------------------------

def _single_table(seed=13):
    indptr, indices, data, shape = _csr(seed, 300, 900, 1, 14)
    J = jrs.build_routed_csr(indptr, indices, data, shape, dtype="df64")
    T = cr.routed_mat_from_arrays(
        np.asarray(J.masks), np.asarray(J.vals), J.kinds, J.dists, J.chunks,
        None if J.inv_perm is None else np.asarray(J.inv_perm), J.shape, J.m,
        J.colmajor, device="cpu")
    return (indptr, indices, data, shape), J, T


def test_single_table_chunk_table_and_product():
    """RoutedMat: chunk c is net-row c's leading rows_c * k_c slots; the
    product through one dfmulred_chunks equals the per-chunk path bit for
    bit, and the JAX package's on the same plan within 4e-14 sum|v x|."""
    (indptr, indices, data, shape), J, T = _single_table()
    assert T.colmajor and len(T.chunks) > 1
    table = trs._single_table_k2(T.chunks, T.m)
    assert trs._single_table_k2(T.chunks, T.m) is table  # built once per plan
    row0 = 0
    for c, ((rows_c, k_c), (slot0, rows, K, r0)) in enumerate(zip(T.chunks, table.spec)):
        assert (slot0, rows, K, r0) == (c * T.m, rows_c, k_c, row0)
        flat = T.vals.reshape(-1, 2)
        assert torch.equal(flat[slot0:slot0 + K * rows], T.vals[c, :rows_c * k_c])
        row0 += rows_c
    x = np.random.default_rng(14).standard_normal(shape[1])
    xd = tdf.from_f64(x, device="cpu")
    yt = trs.routed_spmv_df(T, xd)
    oh, ol = trd.routed_apply([trs._pad_plane(xd.hi, T.m), trs._pad_plane(xd.lo, T.m)],
                              T.masks, T.kinds, T.dists)
    B = len(T.chunks)
    v = T.vals.reshape(-1, 2)
    h, l_ = _per_chunk(v[:, 0], v[:, 1], oh.reshape(-1), ol.reshape(-1),
                       [(c * T.m, r, k) for c, (r, k) in enumerate(T.chunks)])
    if T.inv_perm is not None:
        h, l_ = h[T.inv_perm], l_[T.inv_perm]
    assert _bits_equal(yt.hi, h[: shape[0]]) and _bits_equal(yt.lo, l_[: shape[0]])
    assert oh.numel() == B * T.m
    yj = jdf.to_f64(jrs.routed_spmv_df(J, jdf.from_f64(x), interpret=True))
    scale = _scale(indptr, indices, data, shape, x)
    assert (np.abs(tdf.to_f64(yt) - yj) <= 4e-14 * scale).all()


def _hier():
    indptr, indices, data, shape = _csr(28, 600, 600, 1, 6, dense_rows=150)
    J = jrs.build_routed_csr_hier(indptr, indices, data, shape, dtype="df64", bl=BL)
    T = cr.hier_mat_from_arrays(
        [[np.asarray(mk) for mk in net.pass_masks] for net in J.nets],
        [net.pass_meta for net in J.nets], [np.asarray(v) for v in J.vals],
        None if J.unperm is None else [np.asarray(mk) for mk in J.unperm.pass_masks],
        None if J.unperm is None else J.unperm.pass_meta,
        J.chunks, J.shape, J.m, J.m_out, J.bl, J.n_nz, J.colmajor,
        device="cpu")
    return (indptr, indices, data, shape), J, T


@pytest.mark.parametrize("pack", [True, False], ids=["packed", "net_by_net"])
def test_hier_chunk_tables_and_product(pack, monkeypatch):
    """A table a packed group, the nets packed in groups or one net a group
    (the split _group_cap makes on a short card): net ids[li]'s chunks at
    slots li * m + s0 of the group's planes, rows where the
    chunk-concatenated sorted output puts them; the product equals the
    per-chunk path bit for bit and the JAX package's within 4e-14
    sum|v x|."""
    if not pack:
        monkeypatch.setattr(trs, "_group_cap", lambda M, device: 1)
    (indptr, indices, data, shape), J, T = _hier()
    assert T.colmajor and len(T.chunks) > 1
    groups = tuple(g.net_ids for g in T.groups)
    if not pack:
        assert groups == tuple((ni,) for ni in range(len(T.chunks)))
    tables = trs._hier_k2(T.chunks, groups, T.m)
    assert trs._hier_k2(T.chunks, groups, T.m) is tables
    offs = np.concatenate([[0], np.cumsum(trs._hier_net_rows(T.chunks))])
    assert max(t.rows for t in tables) == offs[-1] == T.n_nz
    for gi, (net_ids, table) in enumerate(zip(groups, tables)):
        want = []
        for li, ni in enumerate(net_ids):
            row0 = offs[ni]
            for s0, rows, K in T.chunks[ni]:
                want.append((li * T.m + s0, rows, K, row0))
                row0 += rows
        assert table.spec == tuple(want)
        # the group's flat value planes at those slots are the net's chunk
        vh = T.groups[gi].vals[0].reshape(-1)
        for (slot0, rows, K, _), (li, ni) in zip(
                table.spec, [(li, ni) for li, ni in enumerate(net_ids)
                             for _ in T.chunks[ni]]):
            net_vals = T.groups[gi].vals[0, li].reshape(-1)
            s0 = slot0 - li * T.m
            assert torch.equal(vh[slot0:slot0 + K * rows], net_vals[s0:s0 + K * rows])
    x = np.random.default_rng(29).standard_normal(shape[1])
    xd = tdf.from_f64(x, device="cpu")
    yt = trs.routed_hier_spmv_df(T, xd)
    # the per-chunk path, net by net
    planes = (trs._pad_plane(xd.hi, T.m), trs._pad_plane(xd.lo, T.m))
    hs, ls = [], []
    for ni in range(len(T.chunks)):
        gi = next(g for g, ids in enumerate(groups) if ni in ids)
        li = groups[gi].index(ni)
        grp = T.groups[gi]
        oh, ol = trd.hier_apply_batched(planes, grp.pass_meta, grp.pass_masks, T.bl)
        oh, ol = oh[li].reshape(-1), ol[li].reshape(-1)
        vh, vl = grp.vals[0, li].reshape(-1), grp.vals[1, li].reshape(-1)
        h, l_ = _per_chunk(vh, vl, oh, ol, T.chunks[ni])
        hs.append(h)
        ls.append(l_)
    want = trs._hier_unperm(T, (torch.cat(hs), torch.cat(ls)))
    assert _bits_equal(yt.hi, want[0]) and _bits_equal(yt.lo, want[1])
    Jr = jrs.pack_hier(J) if pack else J
    yj = jdf.to_f64(jrs.routed_hier_spmv_df(Jr, jdf.from_f64(x), interpret=True))
    scale = _scale(indptr, indices, data, shape, x)
    assert (np.abs(tdf.to_f64(yt) - yj) <= 4e-14 * scale).all()


@pytest.fixture
def data_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("LILAC_DATA_DIR", str(tmp_path))
    return tmp_path


def test_npb_class_s_df64_zeta_unchanged(data_dir, monkeypatch):
    """NPB class S in df64 through the routed operator still verifies, and
    its zeta and residual histories are the per-chunk path's bit for bit."""
    monkeypatch.setenv("LILAC_FACTORED_SEGMODE", "routed")
    new = trun.run("S", dtype="df64", device="cpu")

    def per_chunk(vh, vl, xh, xl, table, out=None):
        h, l_ = _per_chunk(vh, vl, xh, xl, [(a, r, k) for a, r, k, _ in table.spec])
        if out is None:
            return h, l_
        rows = [y + np.arange(r) for _, r, _, y in table.spec]
        idx = torch.as_tensor(np.concatenate(rows))
        out[0][idx], out[1][idx] = h, l_
        return out

    monkeypatch.setattr(tdk, "dfmulred_chunks", per_chunk)
    old = trun.run("S", dtype="df64", device="cpu")
    assert new.verified and new.rel_err <= 1e-10
    assert new.kernel == "factored_routed_df"
    assert np.float64(new.zeta).tobytes() == np.float64(old.zeta).tobytes()
    np.testing.assert_array_equal(np.asarray(new.zeta_history).view(np.uint64),
                                  np.asarray(old.zeta_history).view(np.uint64))
