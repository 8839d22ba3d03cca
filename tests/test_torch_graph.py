"""The graph workloads in lilac_tpu_torch against the JAX package: the
power-law generator, the BFS edge-list reader, PageRank, BFS and the
bench's graph-scale subcommand, plus the package root's exports.

* Host arrays (powerlaw_graph, read_edgelist, normalise_columns) are the
  JAX package's bit for bit.
* PageRank in f64 through the gather path agrees with the JAX run to
  1e-12 relative. In f32 it is held to the JAX package's gather run at
  the reference's own tolerance (rtol 2e-4, atol 1e-7,
  tests/test_graph.py): the routed runs serve K1 (single table) and, with
  kernel="routed_hier" and LILAC_HIER_BL=256, K3-K6 (packed) and K3u-K6u
  (the un-permute network of an unrelabeled plan) through their plain
  versions.
* BFS distances equal bfs_oracle and the JAX run exactly: every sum is of
  ones far below 2^24.
"""

import dataclasses
import functools
import io
import re

import numpy as np
import pytest
import torch

import lilac_tpu_torch
from lilac_tpu.formats import convert as jconv
from lilac_tpu.generate import graphs as jgraphs
from lilac_tpu.io import readers as jrd
from lilac_tpu.plan import SpmvPlan as JPlan
from lilac_tpu.workloads import bfs as jbfs
from lilac_tpu.workloads import pagerank as jpr
from lilac_tpu_torch import bench as tbench
from lilac_tpu_torch.bench import __main__ as tmain
from lilac_tpu_torch.formats import convert as tconv
from lilac_tpu_torch.formats import sparse as tsparse
from lilac_tpu_torch.generate import graphs as tgraphs
from lilac_tpu_torch.io import readers as trd
from lilac_tpu_torch.kernels import routed_spmv as trs
from lilac_tpu_torch.ops import spmv as tops
from lilac_tpu_torch.plan import SpmvPlan
from lilac_tpu_torch.workloads import bfs as tbfs
from lilac_tpu_torch.workloads import pagerank as tpr
from tests.conftest import random_csr

torch.set_num_threads(1)

CPU = "cpu"
F32_TOL = dict(rtol=2e-4, atol=1e-7)  # tests/test_graph.py's own


def _same_arrays(a, b):
    assert len(a) == len(b)
    for u, v in zip(a, b):
        if isinstance(u, np.ndarray):
            assert u.dtype == np.asarray(v).dtype
            np.testing.assert_array_equal(u, np.asarray(v))
        else:
            assert u == v


# -- F2: the package root ---------------------------------------------------------


def test_package_root_exports_the_reference_names():
    """`from lilac_tpu_torch import COO, CSR, ELL, BSR, spmv, SpmvPlan`, as
    `from lilac_tpu import ...` works: the modules' own objects."""
    from lilac_tpu_torch import BSR, COO, CSR, ELL, SpmvPlan as P, spmv

    assert (COO, CSR, ELL, BSR) == (tsparse.COO, tsparse.CSR, tsparse.ELL, tsparse.BSR)
    assert spmv is tops.spmv and P is SpmvPlan
    import lilac_tpu

    for name in ("COO", "CSR", "ELL", "BSR", "spmv", "SpmvPlan"):
        assert hasattr(lilac_tpu, name) and hasattr(lilac_tpu_torch, name)


# -- generator and reader ---------------------------------------------------------


@pytest.mark.parametrize("n, deg, seed, sym", [
    (2000, 8.0, 3, False), (1500, 6.0, 1, False), (900, 5.0, 4, True),
    (1200, 5.0, 2, True), (1, 16.0, 0, True)])
def test_powerlaw_graph_bit_for_bit(n, deg, seed, sym):
    _same_arrays(tgraphs.powerlaw_graph(n, avg_deg=deg, seed=seed, symmetric=sym),
                 jgraphs.powerlaw_graph(n, avg_deg=deg, seed=seed, symmetric=sym))


def test_powerlaw_graph_properties():
    indptr, indices, data, shape = tgraphs.powerlaw_graph(2000, avg_deg=8.0, seed=3)
    n = shape[0]
    counts = np.diff(indptr)
    assert counts.sum() == len(indices) and (indices < n).all()
    assert counts.max() > 8 * max(counts.mean(), 1.0)  # heavy tail
    rows = np.repeat(np.arange(n), counts)
    assert (rows != indices).all()  # no self-loops
    ip, ix, _, _ = tgraphs.powerlaw_graph(900, avg_deg=5.0, seed=4, symmetric=True)
    dense = np.zeros((900, 900), bool)
    dense[np.repeat(np.arange(900), np.diff(ip)), ix] = True
    assert (dense == dense.T).all()


def _edgelist_text(rng, n, nnz, base):
    pairs = rng.integers(0, n, size=(nnz, 2)) + base
    return f"{n} {n} {nnz}\n" + "\n".join(f"{a} {b}" for a, b in pairs) + "\n"


@pytest.mark.parametrize("zero_based", [False, True])
def test_read_edgelist_matches_reference(tmp_path, zero_based):
    """A file (with duplicate edges) reads to the same CSR in both
    packages, by path and from an open file."""
    text = _edgelist_text(np.random.default_rng(5), 40, 300, 0 if zero_based else 1)
    path = tmp_path / "g.txt"
    path.write_text(text)
    got = trd.read_edgelist(str(path), zero_based=zero_based)
    _same_arrays(got, jrd.read_edgelist(str(path), zero_based=zero_based))
    _same_arrays(trd.read_edgelist(io.StringIO(text), zero_based=zero_based), got)
    assert got[3] == (40, 40) and got[2].sum() == 300  # duplicates summed


@pytest.mark.parametrize("body", ["1 2\n3", "1 2\n3 4\n5 6\n", "1 2\nx 4\n"])
def test_read_edgelist_refuses_a_bad_body(tmp_path, body):
    """Short, long and malformed bodies raise in both packages."""
    path = tmp_path / "bad.txt"
    path.write_text("5 5 2\n" + body)
    for reader in (trd.read_edgelist, jrd.read_edgelist):
        with pytest.raises(ValueError):
            reader(str(path))


def test_normalise_columns_bit_for_bit():
    g = tgraphs.powerlaw_graph(1500, avg_deg=6.0, seed=1)
    got = tpr.normalise_columns(*g)
    np.testing.assert_array_equal(got, jpr.normalise_columns(*g))
    colsum = np.zeros(1500)
    np.add.at(colsum, g[1], got)
    nonempty = np.bincount(g[1], minlength=1500) > 0
    np.testing.assert_allclose(colsum[nonempty], 1.0, rtol=1e-12)


# -- PageRank ---------------------------------------------------------------------


def test_pagerank_converges_to_stationary(rng):
    (indptr, indices, data), shape = random_csr(rng, 60, 60, 0.15)
    data = np.abs(data) + 0.1
    r = tpr.run(indptr, indices, data, shape, iters=300, runs=1, dtype="f64", device=CPU)
    assert r.error < 1e-10, r.error
    want = jpr.run(indptr, indices, data, shape, iters=300, runs=1, dtype="f64")
    np.testing.assert_allclose(r.x, want.x, rtol=1e-12, atol=0)
    assert abs(r.error - want.error) <= 1e-14


def test_pagerank_f64_gather_matches_reference():
    g = tgraphs.powerlaw_graph(1500, avg_deg=6.0, seed=1)
    r = tpr.run(*g, iters=30, runs=2, dtype="f64", device=CPU)
    want = jpr.run(*g, iters=30, runs=1, dtype="f64")
    assert r.plan.kernel.startswith("xla_") and r.iters == 30 and len(r.times_s) == 2
    assert r.nnz == want.nnz == len(g[1]) and r.build_s > 0
    np.testing.assert_allclose(r.x, want.x, rtol=1e-12, atol=0)
    np.testing.assert_allclose(r.error, want.error, rtol=1e-12)


@pytest.fixture(scope="module")
def pr_graph():
    g = tgraphs.powerlaw_graph(1500, avg_deg=6.0, seed=1)
    return g, jpr.run(*g, iters=30, runs=1, dtype="f32")


@pytest.mark.parametrize("kernel", ["auto", "routed", "routed_hier"])
def test_pagerank_f32_matches_reference_gather(monkeypatch, pr_graph, kernel):
    """f32 through the port's gather path, its single-table routed plan
    (plain K1) and a packed hierarchical plan at bl = 256 (plain K3-K6),
    relabeled by default for the routed kernels."""
    monkeypatch.setenv("LILAC_HIER_BL", "256")
    g, want = pr_graph
    r = tpr.run(*g, iters=30, runs=1, dtype="f32", kernel=kernel, device=CPU)
    if kernel == "routed_hier":
        assert isinstance(r.plan.A, trs.RoutedMatHierP) and r.plan.A.unperm is None
        assert len(r.plan.A.groups) >= 1 and r.plan.A.bl == 256
    assert r.plan.kernel == {"auto": _gather_kernel(g), "routed": "routed",
                             "routed_hier": "routed_hier"}[kernel]
    np.testing.assert_allclose(r.x, want.x, **F32_TOL)
    np.testing.assert_allclose(r.error, want.error, rtol=2e-3, atol=1e-7)


def _gather_kernel(g):
    return SpmvPlan(*g, dtype="f32", reuse="many", device=CPU).kernel


@pytest.mark.parametrize("kernel", ["routed", "routed_hier"])
def test_pagerank_relabel_same_fixed_point(monkeypatch, kernel):
    """relabel=False keeps the plan's un-permute network (through the plain
    K3u-K6u on the hierarchical plan); the fixed point is the relabeled
    run's, and the JAX package's relabel gives the same x."""
    monkeypatch.setenv("LILAC_HIER_BL", "256")
    g = tgraphs.powerlaw_graph(1200, avg_deg=6.0, seed=3)
    kw = dict(iters=25, runs=1, dtype="f32", kernel=kernel, device=CPU)
    r1 = tpr.run(*g, relabel=False, **kw)
    r2 = tpr.run(*g, relabel=True, **kw)
    if kernel == "routed_hier":
        assert r1.plan.A.unperm is not None and r2.plan.A.unperm is None
    np.testing.assert_allclose(r1.x, r2.x, **F32_TOL)
    np.testing.assert_allclose(r1.error, r2.error, rtol=2e-3, atol=1e-7)
    want = jpr.run(*g, iters=25, runs=1, dtype="f32", kernel="routed", relabel=True)
    np.testing.assert_allclose(r2.x, want.x, **F32_TOL)


def test_pagerank_prestaged_plan():
    """A plan staged from the scaled values gives the run's own result;
    relabel=True with a pre-staged plan raises in both packages."""
    g = tgraphs.powerlaw_graph(800, avg_deg=5.0, seed=6)
    scaled = tpr.normalise_columns(*g) * 0.85
    plan = SpmvPlan(g[0], g[1], scaled, g[3], dtype="f64", reuse="many", device=CPU)
    r = tpr.run(*g, iters=20, runs=1, dtype="f64", plan=plan)
    assert r.plan is plan and r.build_s == 0.0
    np.testing.assert_array_equal(r.x, tpr.run(*g, iters=20, runs=1, dtype="f64",
                                               device=CPU).x)
    jplan = JPlan(g[0], g[1], scaled, g[3], dtype="f64", reuse="many")
    for run, p in ((tpr.run, plan), (jpr.run, jplan)):
        with pytest.raises(ValueError, match="pre-staged"):
            run(*g, iters=2, runs=1, plan=p, relabel=True)


# -- BFS --------------------------------------------------------------------------


def test_bfs_random_graph(rng):
    (indptr, indices, data), shape = random_csr(rng, 80, 80, 0.04)
    plan = SpmvPlan(indptr, indices, np.ones_like(data), shape, dtype="f32", device=CPU)
    jplan = JPlan(indptr, indices, np.ones_like(data), shape, dtype="f32")
    for src in (0, 17, 42):
        got = tbfs.bfs_distances(plan, src)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, tbfs.bfs_oracle(indptr, indices, data, shape, src))
        np.testing.assert_array_equal(got, jbfs.bfs_distances(jplan, src))
    np.testing.assert_array_equal(tbfs.bfs_oracle(indptr, indices, data, shape, 5),
                                  jbfs.bfs_oracle(indptr, indices, data, shape, 5))


@pytest.mark.parametrize("kernel", ["routed", "routed_hier"])
def test_bfs_routed_matches_oracle(monkeypatch, kernel):
    monkeypatch.setenv("LILAC_HIER_BL", "256")
    g = tgraphs.powerlaw_graph(1200, avg_deg=5.0, seed=2, symmetric=True)
    plan = SpmvPlan(g[0], g[1], np.ones_like(g[2]), g[3], dtype="f32",
                    kernel=kernel, device=CPU)
    assert plan.kernel == kernel
    for src in (7, 300):
        np.testing.assert_array_equal(tbfs.bfs_distances(plan, src), tbfs.bfs_oracle(*g, src))


def test_bfs_relabel_distances_match_oracle():
    """BFS on the relabeled graph from the rank-mapped source, mapped back,
    equals the oracle on the graph's own numbering, and the JAX run."""
    g = tgraphs.powerlaw_graph(900, avg_deg=5.0, seed=4, symmetric=True)
    ip, ix, dv, order, rank = tconv.length_relabel_csr(*g)
    _same_arrays((ip, ix, dv, order, rank), jconv.length_relabel_csr(*g))
    plan = SpmvPlan(ip, ix, np.ones_like(dv), g[3], dtype="f32", kernel="routed", device=CPU)
    d_rel = tbfs.bfs_distances(plan, int(rank[11]))
    d_nat = np.empty_like(d_rel)
    d_nat[order] = d_rel
    np.testing.assert_array_equal(d_nat, tbfs.bfs_oracle(*g, 11))
    jplan = JPlan(ip, ix, np.ones_like(dv), g[3], dtype="f32", kernel="routed")
    np.testing.assert_array_equal(d_rel, jbfs.bfs_distances(jplan, int(rank[11])))


@pytest.mark.parametrize("kernel", ["auto", "routed", "routed_hier"])
def test_bfs_run_benchmark(monkeypatch, kernel):
    """run_benchmark draws the JAX package's sources; every run's
    distances, mapped back to the graph's numbering, equal the oracle."""
    monkeypatch.setenv("LILAC_HIER_BL", "256")
    g = tgraphs.powerlaw_graph(1000, avg_deg=5.0, seed=7, symmetric=True)
    r = tbfs.run_benchmark(*g, runs=4, seed=3, kernel=kernel, device=CPU)
    want = jbfs.run_benchmark(*g, runs=4, seed=3)
    assert (r.runs, r.n, r.nnz) == (want.runs, want.n, want.nnz) == (4, 1000, len(g[1]))
    np.testing.assert_array_equal(r.sources, np.random.default_rng(3).integers(0, 1000, 4))
    assert r.distances.shape == (4, 1000) and r.time_s > 0 and r.build_s > 0
    for s, d in zip(r.sources, r.distances):
        np.testing.assert_array_equal(d, tbfs.bfs_oracle(*g, int(s)))


# -- the bench --------------------------------------------------------------------


def _on_cpu(monkeypatch):
    monkeypatch.setattr(tpr, "run", functools.partial(tpr.run, device=CPU))
    monkeypatch.setattr(tbfs, "run_benchmark", functools.partial(tbfs.run_benchmark,
                                                                 device=CPU))


@pytest.mark.parametrize("workload", ["pagerank", "bfs"])
def test_graph_scale_cli(monkeypatch, capsys, workload):
    """graph-scale --n 2000 --iters 8 through the port's CLI prints the JAX
    package's lines; PageRank's err is the JAX run's to f32 rounding."""
    _on_cpu(monkeypatch)
    assert tmain.main(["graph-scale", "--n", "2000", "--iters", "8",
                       "--workload", workload]) == 0
    out = capsys.readouterr().out.splitlines()
    sym = workload == "bfs"
    g = tgraphs.powerlaw_graph(2000, avg_deg=16.0, seed=0, symmetric=sym)
    assert out[0] == f"generating power-law graph n=2000 avg_deg=16.0 symmetric={sym}"
    assert len(out) == 3
    for line, kernel in zip(out[1:], ("auto", "routed")):
        if sym:
            assert re.fullmatch(rf"  bfs      n=2000 nnz={len(g[1])} kernel={kernel:12s}"
                                r" +[0-9.]+ s / 16 sources", line), line
        else:
            m = re.fullmatch(rf"  pagerank n=2000 nnz={len(g[1])} kernel={kernel:12s}"
                             r" +[0-9.]+ s/run +[0-9.]+ Gnnz/s  err=(\S+)", line)
            assert m, line
            want = jpr.run(*g, iters=8, runs=1)
            np.testing.assert_allclose(float(m.group(1)), want.error, rtol=2e-3)


def test_bench_pagerank_runs_on_random_crs(monkeypatch):
    """bench run --bench pagerank: random_crs(size, seed=1), 1024
    iterations, one timed run a row entry."""
    _on_cpu(monkeypatch)
    row = tbench.run_bench("pagerank", "4", runs=2, platform="cpu")
    assert row.csv()[:4] == ["cpu", "pagerank", "auto", "4"]
    assert len(row.times) == 2 and all(t > 0 for t in row.times)


def test_results_keep_the_reference_fields():
    for t, j in ((tpr.PageRankResult, jpr.PageRankResult), (tbfs.BFSResult, jbfs.BFSResult)):
        names = [f.name for f in dataclasses.fields(t)]
        assert names[: len(dataclasses.fields(j))] == [f.name for f in dataclasses.fields(j)]
