"""lilac_tpu_torch.kernels.dfadj: the df64 transpose product's glue, on the CPU.

The df64 adjoints of kernels/routed_spmv.py hand a column-major plan's
planes on a card to csrc/dfadj.cu's two kernels: slots_mul (the row
cotangents expanded over K2's chunk table, then df.mul by the values) and
netsum (df.sum_df0 over the nets, then df.add into the sum over groups).
Here, with no card:

* slots_mul_plain, the card tests' reference for slots_mul on any chunk
  table, is the chain it replaced (_adj_slots / _hier_adj_slots, then
  df.mul) bit for bit, for the tables of a single-table plan and of a
  hierarchical plan in one group and in several;
* slots_mul's block list (K2's thread blocks, then the gap pieces), run by
  a numpy emulation of the kernel's grid, writes every slot once with the
  chain's operands, on the plans' tables and on ragged tables with gaps,
  pads and negative zeros;
* netsum_plain is df.sum_df0, and df.add after it; an emulation of the
  kernel's register tree and of its one-level launches gives its bits;
* both adjoints' CPU results are the chains' of the parent bit for bit, in
  either slot layout, and never touch the CUDA library;
* where the kernels are taken (a column-major plan on a card), the
  adjoints hand each group to slots_mul with its K2 table and to netsum
  with the sum so far: with the references in their place, the parents'
  bits, one call of each a group;
* the CUDA-only entries raise on planes they do not take.

The kernels themselves are held to these plain versions on a card in
test_torch_dfadj_card.py.
"""

import os
import re

import numpy as np
import pytest
import torch

from lilac_tpu_torch.kernels import _cuda, dfadj
from lilac_tpu_torch.kernels import dfmulred as tdk
from lilac_tpu_torch.kernels import routed as trd
from lilac_tpu_torch.kernels import routed_spmv as trs
from lilac_tpu_torch.ops import dfloat as tdf
from tests.test_torch_dfadj_card import slots_mul_plain

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


def _single(colmajor=True):
    return trs.build_routed_csr(*_csr(13, 300, 900, 1, 14), dtype="df64",
                                colmajor=colmajor, device="cpu")


def _hier(monkeypatch, groups, colmajor=True):
    """A df64 hier plan of 3 nets with an un-permute network, a dense
    column and gaps between chunks; `groups` "one" packs the nets in one
    group, "several" one net a group (the split _group_cap makes on a
    short card)."""
    if groups == "several":
        monkeypatch.setattr(trs, "_group_cap", lambda M, device: 1)
    M = trs.build_routed_csr_hier(*_csr(28, 600, 600, 1, 6, dense_rows=150),
                                  dtype="df64", bl=BL, colmajor=colmajor)
    P = trs.pack_hier(M, "cpu")
    assert len(P.chunks) > 1 and P.unperm is not None
    assert len(P.groups) == (1 if groups == "one" else len(P.chunks))
    return P


def _bits(t):
    return t.contiguous().view(torch.int32)


def _same(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(_bits(g), _bits(w))


def _cotangents(rng, n):
    """[2, n] df cotangents over 12 decades, some +-0 words."""
    u = rng.standard_normal(n) * 10.0 ** rng.uniform(-6, 6, n)
    u[rng.random(n) < 0.05] = -0.0
    s = tdf.split_f64_np(u)
    us = torch.as_tensor(np.ascontiguousarray(s.T))
    us[1, rng.random(n) < 0.1] = -0.0
    return us


def _table_cases(monkeypatch):
    """(values hi, lo, sorted cotangents, table, the chain's product) of the
    single-table plan and of each group of the hier plans."""
    rng = np.random.default_rng(7)
    T = _single()
    us = _cotangents(rng, T.shape[0])
    v = T.vals.reshape(-1, 2)
    sl = trs._adj_slots(T, us)
    want = tdf.mul(tdf.DF(T.vals[..., 0], T.vals[..., 1]), tdf.DF(sl[0], sl[1]))
    cases = [(v[:, 0], v[:, 1], us, trs._single_table_k2(T.chunks, T.m),
              tdf.DF(want.hi.reshape(-1), want.lo.reshape(-1)))]
    for groups in ("one", "several"):
        with monkeypatch.context() as mp:
            P = _hier(mp, groups)
        us = _cotangents(rng, P.n_nz)
        tables = trs._hier_k2(P.chunks, tuple(g.net_ids for g in P.groups), P.m)
        for grp, table in zip(P.groups, tables):
            N = len(grp.net_ids)
            sl = trs._hier_adj_slots(P, us, grp.net_ids)
            want = tdf.mul(tdf.DF(grp.vals[0].reshape(N, P.m), grp.vals[1].reshape(N, P.m)),
                           tdf.DF(sl[0], sl[1]))
            cases.append((grp.vals[0].reshape(-1), grp.vals[1].reshape(-1), us, table,
                          tdf.DF(want.hi.reshape(-1), want.lo.reshape(-1))))
    return cases


def test_slots_mul_plain_is_the_expand_and_mul_chain(monkeypatch):
    """slots_mul_plain on K2's tables (single table, interleaved values;
    a hier plan in one group and in several) is the chain bit for bit."""
    cases = _table_cases(monkeypatch)
    assert len(cases) == 1 + 1 + 3
    for vh, vl, us, table, want in cases:
        _same(slots_mul_plain(vh, vl, us[0], us[1], table), want)


def _emulate_slots_mul(vh, vl, uh, ul, blocks):
    """csrc/dfadj.cu's slots_mul grid over its block list: each block's
    slots given their cotangent (a chunk block, thread r on row y0 + r at
    slots v0 + k R + r) or +0 (a gap piece), then df.mul elementwise;
    checks that every slot is written once."""
    S = vh.shape[0]
    uh_s, ul_s = torch.zeros(S), torch.zeros(S)
    written = np.zeros(S, np.int64)
    for v0, y0, R, kn in blocks.tolist():
        if y0 < 0:
            assert 1 <= kn <= tdk.GAP_SLOTS
            written[v0:v0 + kn] += 1
            continue
        K, n = kn >> 32, kn & 0xFFFFFFFF
        assert 1 <= n <= tdk.K2_ROWS
        r = np.arange(n)
        for k in range(K):
            s = torch.as_tensor(v0 + k * R + r)
            uh_s[s], ul_s[s] = uh[y0 + r], ul[y0 + r]
            written[v0 + k * R + r] += 1
    assert (written == 1).all()
    return tdf.mul(tdf.DF(vh, vl), tdf.DF(uh_s, ul_s))


def test_slots_mul_blocks_on_the_plans_tables(monkeypatch):
    for vh, vl, us, table, want in _table_cases(monkeypatch):
        blocks = table.blocks_on("cpu", vh.shape[0])
        assert table.blocks_on("cpu", vh.shape[0]) is blocks  # built once
        assert torch.equal(blocks[: len(table.blocks)], torch.as_tensor(table.blocks))
        _same(_emulate_slots_mul(vh, vl, us[0], us[1], blocks), want)


def _ragged(rng, nchunks):
    """(slot0, rows, K, row0) chunks in a shuffled order with gaps (some
    longer than a gap piece) between them, K from 0, and a pad after."""
    spec, slot, row0 = [], int(rng.integers(0, 5000)), 0
    for _ in range(nchunks):
        rows = int(rng.integers(1, 3 * tdk.K2_ROWS))
        K = int(rng.integers(0, 9))
        spec.append((slot, rows, K, row0))
        slot += rows * K + int(rng.choice([0, 1, 37, 3 * tdk.GAP_SLOTS + 5]))
        row0 += rows
    order = rng.permutation(nchunks)
    return [spec[i] for i in order], slot + int(rng.integers(0, 3000)), row0


@pytest.mark.parametrize("interleaved", [True, False], ids=["interleaved", "planes"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slots_mul_on_ragged_tables(seed, interleaved):
    """Gaps, pads and negative zeros: the plain version and the emulated
    grid agree bit for bit, the pads times +0 as the zero-filled chain has
    them, and the gap pieces cover exactly what no chunk does."""
    rng = np.random.default_rng(seed)
    spec, S, rows = _ragged(rng, 2 + 5 * seed)
    table = tdk.ChunkTable(spec)
    v = rng.standard_normal(S) * 10.0 ** rng.uniform(-6, 6, S)
    v[rng.random(S) < 0.05] = -0.0
    pairs = torch.as_tensor(tdf.split_f64_np(v))
    pairs[rng.random(S) < 0.1, 1] = -0.0
    vh, vl = ((pairs[:, 0], pairs[:, 1]) if interleaved
              else (pairs[:, 0].contiguous(), pairs[:, 1].contiguous()))
    us = _cotangents(rng, rows + 3)
    got = slots_mul_plain(vh, vl, us[0], us[1], table)
    _same(_emulate_slots_mul(vh, vl, us[0], us[1], table.blocks_on("cpu", S)), got)
    covered = np.zeros(S, bool)
    for s0, r, K, _ in spec:
        covered[s0:s0 + r * K] = True
    zero = tdf.mul(tdf.DF(vh, vl), tdf.DF(torch.zeros(S), torch.zeros(S)))
    free = torch.as_tensor(~covered)
    assert torch.equal(_bits(got.hi)[free], _bits(zero.hi)[free])
    assert torch.equal(_bits(got.lo)[free], _bits(zero.lo)[free])
    gaps = table.gap_pieces(S)
    mark = np.zeros(S, np.int64)
    for s0, y0, R, n in gaps.tolist():
        assert y0 == -1 and R == 0 and 1 <= n <= tdk.GAP_SLOTS
        mark[s0:s0 + n] += 1
    assert np.array_equal(mark, (~covered).astype(np.int64))


def _net_planes(rng, k, m):
    a = rng.standard_normal((k, m)) * 10.0 ** rng.uniform(-4, 4, (k, m))
    a[:, ::3] = -a[0, ::3]  # columns that cancel
    a[rng.random((k, m)) < 0.05] = -0.0
    s = tdf.split_f64_np(a)
    return torch.as_tensor(s[..., 0]), torch.as_tensor(s[..., 1])


def _tree(rows):
    """csrc/dfadj.cu's netsum_kernel<K>: tree<K> over the K rows held in
    registers (row i + H into row i, +0 past the last)."""
    k = len(rows)
    while k > 1:
        h = (k + 1) // 2
        zero = tdf.DF(torch.zeros_like(rows[0].hi), torch.zeros_like(rows[0].lo))
        rows = [tdf.add(rows[i], rows[i + h] if i + h < k else zero) for i in range(h)]
        k = h
    return rows[0]


def _emulate_netsum(oh, ol, acc):
    """netsum's launches: one-level launches down to MAX_NETS rows, then
    the register tree, then df.add(acc, it)."""
    k = oh.shape[0]
    while k > dfadj.MAX_NETS:
        h = (k + 1) // 2
        zero = torch.zeros_like(oh[:1])
        other_h = torch.cat([oh[h:], zero]) if k % 2 else oh[h:]
        other_l = torch.cat([ol[h:], zero]) if k % 2 else ol[h:]
        r = tdf.add(tdf.DF(oh[:h], ol[:h]), tdf.DF(other_h, other_l))
        oh, ol, k = r.hi, r.lo, h
    t = _tree([tdf.DF(oh[i], ol[i]) for i in range(k)])
    return t if acc is None else tdf.add(acc, t)


@pytest.mark.parametrize("with_acc", [False, True], ids=["alone", "into_acc"])
@pytest.mark.parametrize("k", [1, 2, 3, 5, 16, 17, 33, 70])
def test_netsum_plain_is_sum_df0_then_add(k, with_acc):
    rng = np.random.default_rng(k + 100 * with_acc)
    oh, ol = _net_planes(rng, k, 515)
    acc = None
    if with_acc:
        ah, al = _net_planes(rng, 1, 515)
        acc = tdf.DF(ah[0], al[0])
    t = tdf.sum_df0(tdf.DF(oh, ol))
    want = t if acc is None else tdf.add(acc, t)
    got = dfadj.netsum_plain(oh, ol, acc)
    _same(got, want)
    _same(_emulate_netsum(oh, ol, acc), want)


def _parent_adj(A, u):
    """The df64 adjoints as the parent ran them: the op chains throughout."""
    if isinstance(A, trs.RoutedMat):
        B, R = len(A.chunks), A.m // 128
        sl = trs._adj_slots(A, trs._adj_sorted(A, torch.stack([u.hi, u.lo])))
        prod = tdf.mul(tdf.DF(A.vals[..., 0], A.vals[..., 1]), tdf.DF(sl[0], sl[1]))
        oh, ol = trd.routed_apply_t([prod.hi.view(B, R, 128), prod.lo.view(B, R, 128)],
                                    A.masks, A.kinds, A.dists, dfpair=True)
        y = tdf.sum_df0(tdf.DF(oh.view(B, A.m), ol.view(B, A.m)))
        return tdf.DF(y.hi[: A.shape[1]], y.lo[: A.shape[1]])
    R, n = A.m // 128, A.shape[0]
    us = trs._hier_adj_unperm(A, torch.stack([u.hi[:n], u.lo[:n]]), True)
    y = None
    for grp in A.groups:
        N = len(grp.net_ids)
        sl = trs._hier_adj_slots(A, us, grp.net_ids)
        prod = tdf.mul(tdf.DF(grp.vals[0].reshape(N, A.m), grp.vals[1].reshape(N, A.m)),
                       tdf.DF(sl[0], sl[1]))
        oh, ol = trd.hier_apply_batched_t(
            (prod.hi.reshape(N, R, 128), prod.lo.reshape(N, R, 128)),
            grp.pass_meta, grp.pass_masks, A.bl, dfpair=True)
        t = tdf.sum_df0(tdf.DF(oh.view(N, A.m), ol.view(N, A.m)))
        y = t if y is None else tdf.add(y, t)
    return tdf.DF(y.hi[: A.shape[1]], y.lo[: A.shape[1]])


@pytest.fixture
def no_cuda_library(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("CUDA library touched for a CPU tensor")

    monkeypatch.setattr(_cuda, "load", boom)
    monkeypatch.setattr(_cuda, "build_all", boom)
    before = dict(dfadj.launches)
    yield
    assert dfadj.launches == before


@pytest.mark.parametrize("colmajor", [True, False], ids=["colmajor", "rowmajor"])
@pytest.mark.parametrize("plan", ["single", "hier_one_group", "hier_several_groups"])
def test_adjoints_on_the_cpu_are_the_parents(no_cuda_library, monkeypatch, plan, colmajor):
    if plan == "single":
        A = _single(colmajor)
        fn = trs.routed_spmv_adj_t_df
    else:
        A = _hier(monkeypatch, plan.rsplit("_", 2)[1], colmajor)
        fn = trs.routed_hier_spmv_adj_t_df
    assert A.colmajor == colmajor
    rng = np.random.default_rng(11)
    u = tdf.DF(*_cotangents(rng, A.shape[0]))
    _same(fn(A, u), _parent_adj(A, u))


@pytest.mark.parametrize("plan", ["single", "hier_one_group", "hier_several_groups"])
def test_adjoints_hand_each_group_to_the_kernels(no_cuda_library, monkeypatch, plan):
    if plan == "single":
        A = _single()
        fn, groups = trs.routed_spmv_adj_t_df, 1
    else:
        A = _hier(monkeypatch, plan.rsplit("_", 2)[1])
        fn, groups = trs.routed_hier_spmv_adj_t_df, len(A.groups)
    calls = {"slots_mul": 0, "netsum": 0}

    def slots_mul(vh, vl, uh, ul, table):
        calls["slots_mul"] += 1
        assert vh.shape == vl.shape and table.slots <= vh.shape[0]
        return slots_mul_plain(vh, vl, uh, ul, table)

    def netsum(oh, ol, acc=None):
        calls["netsum"] += 1
        assert (acc is None) == (calls["netsum"] == 1)
        return dfadj.netsum_plain(oh, ol, acc)

    monkeypatch.setattr(trs, "_dfadj_takes", lambda A, us: A.colmajor)
    monkeypatch.setattr(dfadj, "slots_mul", slots_mul)
    monkeypatch.setattr(dfadj, "netsum", netsum)
    rng = np.random.default_rng(12)
    u = tdf.DF(*_cotangents(rng, A.shape[0]))
    _same(fn(A, u), _parent_adj(A, u))
    assert calls == {"slots_mul": groups, "netsum": groups}


def _refused_slots():
    v, z = torch.ones(64), torch.zeros(64)
    return {
        "cpu": (v, z, v, z),
        "f64": (v.double(), z.double(), v.double(), z.double()),
        "2-D": (v.view(8, 8), z.view(8, 8), v, z),
        "meta": (torch.ones(64, device="meta"), torch.zeros(64, device="meta"), v, z),
    }


@pytest.mark.parametrize("kind", list(_refused_slots()))
def test_cuda_only_entries_raise_on_planes_they_do_not_take(no_cuda_library, kind):
    table = tdk.ChunkTable([(0, 8, 4, 0)])
    with pytest.raises(ValueError, match="CUDA"):
        dfadj.slots_mul(*_refused_slots()[kind], table)
    oh, ol = _refused_slots()[kind][:2]
    if oh.dim() == 1:
        oh, ol = oh.view(8, 8), ol.view(8, 8)
    with pytest.raises(ValueError, match="CUDA"):
        dfadj.netsum(oh, ol)
    with pytest.raises(ValueError, match="CUDA"):
        dfadj.netsum(oh, ol, tdf.DF(oh[0], ol[0]))


def test_launch_counter_spans_and_register_width():
    assert set(dfadj.launches) == {"slots_mul", "netsum"}
    assert "dfadj" in _cuda.SOURCES
    assert dfadj._ADJMUL.name == "lilac.kernels.adjmul"
    assert dfadj._NETSUM.name == "lilac.kernels.netsum"
    with open(_cuda.source_path("dfadj")) as f:
        src = f.read()
    assert int(re.search(r"kMaxNets = (\d+);", src).group(1)) == dfadj.MAX_NETS
    assert os.path.basename(_cuda.source_path("dfadj")) == "dfadj.cu"
