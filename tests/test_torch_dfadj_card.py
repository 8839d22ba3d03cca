"""The kernels of csrc/dfadj.cu against their plain versions (the df64
adjoint's op chains) on a CUDA card, bit for bit on int32 views.

slots_mul on the tables of NPB class D's group shapes (16 nets and an odd
15, m = 2^21, one chunk a net and a pad), SparseBench 160's (m = 2^22,
groups of 1 to 3 nets of ragged chunks) and random ragged tables with
gaps, pads and negative zeros, values contiguous or interleaved; netsum at
those shapes, one launch up to MAX_NETS nets and beyond, alone and into an
accumulator; and both df64 adjoints on small plans, one slots_mul and one
netsum a group, their results the chains'.

Marked `card`: it skips where there is no CUDA card or no nvcc. It imports
no JAX, so on a machine with a card it runs on its own, without the JAX
settings of tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_dfadj_card.py
"""

import os
import shutil

import numpy as np
import pytest
import torch

from lilac_tpu_torch.kernels import dfadj
from lilac_tpu_torch.kernels import dfmulred as dfk
from lilac_tpu_torch.kernels import routed_spmv as rs
from lilac_tpu_torch.ops import dfloat as df

BL = 256


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")
    if not (shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc")
            or os.environ.get("CUDA_HOME")):
        pytest.skip("needs nvcc to build csrc/dfadj.cu")


def _same(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype and g.is_cuda
        g, w = g.contiguous(), w.contiguous()
        diff = g.view(torch.int32) != w.view(torch.int32)
        assert not bool(diff.any()), int(diff.sum())


def slots_mul_plain(vh, vl, uh, ul, table: dfk.ChunkTable) -> df.DF:
    """What slots_mul computes, on any ChunkTable, as the adjoints' op
    chain does it: [S] slot planes zero-filled, each chunk's [K, rows]
    terms given their rows' cotangents, then df.mul by the values."""
    sl = uh.new_zeros((2, vh.shape[0]))
    for slot0, rows, K, row0 in table.spec:
        src = torch.stack([uh[row0:row0 + rows], ul[row0:row0 + rows]])
        sl[:, slot0:slot0 + K * rows].view(2, K, rows).copy_(
            src.unsqueeze(1).expand(2, K, rows))
    return df.mul(df.DF(vh, vl), df.DF(sl[0], sl[1]))


def _pairs(rng, shape):
    """df values over 12 decades on the card, some hi words +-0 and some lo
    words -0."""
    a = rng.standard_normal(shape) * 10.0 ** rng.uniform(-6, 6, shape)
    a[rng.random(shape) < 0.02] = -0.0
    a[rng.random(shape) < 0.02] = 0.0
    s = torch.as_tensor(df.split_f64_np(a))
    s[..., 1][torch.as_tensor(rng.random(shape) < 0.1)] = -0.0
    return s.cuda()


def _npb_d_table(nets):
    """Class D's group: one chunk a net, 1 500 000 rows over 16 nets, 22
    terms a row, at slot li * m of the group's planes; a pad after each."""
    m, rows, K = 1 << 21, 1_500_000 // 16, 22
    return dfk.ChunkTable([(li * m, rows, K, li * rows) for li in range(nets)]), nets * m


def _sb160_table(rng, nets):
    """SparseBench 160's shape: m = 2^22, each net's rows in chunks of
    falling length (12 terms down to 1), short gaps between them."""
    m, spec, row0 = 1 << 22, [], 0
    for li in range(nets):
        slot = li * m
        for K in range(12, 0, -1):
            rows = int(rng.integers(20_000, 60_000))
            if slot + rows * K + 64 > (li + 1) * m:
                break
            spec.append((slot, rows, K, row0))
            slot += rows * K + int(rng.integers(0, 64))
            row0 += rows
    return dfk.ChunkTable(spec), nets * m


def _ragged_table(rng, nchunks):
    spec, slot, row0 = [], int(rng.integers(0, 5000)), 0
    for _ in range(nchunks):
        rows = int(rng.integers(1, 3 * dfk.K2_ROWS))
        K = int(rng.integers(0, 30))
        spec.append((slot, rows, K, row0))
        slot += rows * K + int(rng.choice([0, 1, 37, 3 * dfk.GAP_SLOTS + 5]))
        row0 += rows
    order = rng.permutation(nchunks)
    return dfk.ChunkTable([spec[i] for i in order]), slot + int(rng.integers(0, 3000))


TABLES = ["npb_d_16", "npb_d_15", "sb160_3", "sb160_1", "ragged_0", "ragged_1", "ragged_2"]


def _table(name, rng):
    kind, arg = name.rsplit("_", 1)
    if kind == "npb_d":
        return _npb_d_table(int(arg))
    if kind == "sb160":
        return _sb160_table(rng, int(arg))
    return _ragged_table(rng, 3 + 7 * int(arg))


@pytest.mark.card
@pytest.mark.parametrize("interleaved", [False, True], ids=["planes", "interleaved"])
@pytest.mark.parametrize("name", TABLES)
def test_slots_mul_is_the_chain(name, interleaved):
    _card()
    rng = np.random.default_rng(TABLES.index(name))
    table, S = _table(name, rng)
    v = _pairs(rng, S)
    vh, vl = (v[:, 0], v[:, 1]) if interleaved else (v[:, 0].contiguous(),
                                                      v[:, 1].contiguous())
    u = _pairs(rng, table.rows + 5)
    uh, ul = u[:, 0].contiguous(), u[:, 1].contiguous()
    before = dfadj.launches["slots_mul"]
    got = dfadj.slots_mul(vh, vl, uh, ul, table)
    assert dfadj.launches["slots_mul"] == before + 1
    _same(got, slots_mul_plain(vh, vl, uh, ul, table))


NETSUM_SHAPES = [(16, 1 << 21), (15, 1 << 21), (3, 1 << 22), (1, 1 << 22), (2, 4097),
                 (32, 1000), (33, 4097), (70, 1000), (17, 1)]


@pytest.mark.card
@pytest.mark.parametrize("with_acc", [False, True], ids=["alone", "into_acc"])
@pytest.mark.parametrize("k,m", NETSUM_SHAPES)
def test_netsum_is_the_chain(k, m, with_acc):
    _card()
    rng = np.random.default_rng(k * 7 + m % 13 + with_acc)
    x = _pairs(rng, (k, m))
    oh, ol = x[..., 0].contiguous(), x[..., 1].contiguous()
    oh[1::2, ::3] = -oh[0, ::3]  # columns whose hi words cancel
    acc = None
    if with_acc:
        a = _pairs(rng, m)
        acc = df.DF(a[:, 0].contiguous(), a[:, 1].contiguous())
    before = dfadj.launches["netsum"]
    got = dfadj.netsum(oh, ol, acc)
    levels, kk = 0, k
    while kk > dfadj.MAX_NETS:
        kk, levels = (kk + 1) // 2, levels + 1
    assert dfadj.launches["netsum"] == before + 1 + levels
    _same(got, dfadj.netsum_plain(oh, ol, acc))


def _csr(seed, n, ncol, kmin, kmax, dense_rows=0):
    rng = np.random.default_rng(seed)
    counts = rng.integers(kmin, kmax + 1, size=n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    indices = rng.integers(0, ncol, size=int(indptr[-1]))
    indices[indptr[rng.choice(n, size=dense_rows, replace=False)]] = 7
    return indptr, indices, rng.standard_normal(len(indices)), (n, ncol)


def _chain(fn, A, u, monkeypatch):
    """fn(A, u) through the op chains the adjoints ran before the kernels
    (and still run for row-major plans and on the CPU)."""
    with monkeypatch.context() as mp:
        mp.setattr(rs, "_dfadj_takes", lambda A, us: False)
        before = dict(dfadj.launches)
        out = fn(A, u)
        assert dfadj.launches == before
        return out


@pytest.mark.card
@pytest.mark.parametrize("colmajor", [True, False], ids=["colmajor", "rowmajor"])
@pytest.mark.parametrize("plan", ["single", "hier_one_group", "hier_net_a_group"])
def test_adjoints_launch_one_of_each_a_group(plan, colmajor, monkeypatch):
    """One slots_mul and one netsum a group of a column-major plan (none for
    a row-major plan, which keeps the chains), each inside its span, and
    the transpose product the chains' bit for bit."""
    _card()
    if plan == "single":
        A = rs.build_routed_csr(*_csr(13, 300, 900, 1, 14), dtype="df64",
                                colmajor=colmajor, device="cuda")
        fn, groups = rs.routed_spmv_adj_t_df, 1
    else:
        with monkeypatch.context() as mp:
            if plan == "hier_net_a_group":
                mp.setattr(rs, "_group_cap", lambda M, device: 1)
            M = rs.build_routed_csr_hier(*_csr(28, 600, 600, 1, 6, dense_rows=150),
                                         dtype="df64", bl=BL, colmajor=colmajor)
            A = rs.pack_hier(M, "cuda")
        fn, groups = rs.routed_hier_spmv_adj_t_df, len(A.groups)
        assert groups == (1 if plan == "hier_one_group" else len(A.chunks)) > 0
    rng = np.random.default_rng(3)
    u = _pairs(rng, A.shape[0])
    u = df.DF(u[:, 0].contiguous(), u[:, 1].contiguous())
    before = dict(dfadj.launches)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = fn(A, u)
        torch.cuda.synchronize()
    n = groups if colmajor else 0
    assert dfadj.launches == {"slots_mul": before["slots_mul"] + n,
                              "netsum": before["netsum"] + n}
    spans = [e.name for e in prof.events()]
    assert spans.count("lilac.kernels.adjmul") == spans.count("lilac.kernels.netsum") == n
    _same(got, _chain(fn, A, u, monkeypatch))
