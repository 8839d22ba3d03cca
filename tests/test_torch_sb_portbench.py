"""SparseBench's timed BiCG as the benchmark runs it (portbench's
configuration kind ``sparsebench_bicg``), on the CPU at sizes 8 to 12.

* The benchmark's plain reference (portbench/reference/sparsebench.py)
  generates the program's matrix (generate/random_crs.py) and its row
  numbering σ (formats/convert.py:length_relabel_csr) bit for bit.
* ``BenchSolver`` through SpmvPlan's hierarchical routed plan, forced at
  bl = 256 (K3-K5 and K7-K9, and K2 in df64, through their plain
  versions), Aᵀ by the plan run in reverse, agrees with the reference's
  BiCG in IEEE double from the same b (handed to the program in σ's
  numbering): the same its; the first HIST_FIRST norms within 1e-7
  relative, since hist is float32 and its rounding alone is up to 2^-24 =
  5.96e-8 relative (later norms pass BiCG's near-breakdowns on these
  matrices, which amplify any rounding: at size 10 two f64 runs that sum in
  other orders end up to a factor 4.7 apart); the recurrence norm within
  1e-12 (df64) / 1e-14 (f64) of the true residual ||b - A x||, the
  reference's f64 product of the program's x.
* Repeat solves are bit-identical, and ``benchmark`` times that solve. A
  second solver of the matrix reads the plan from its file without
  generating the matrix and solves bit for bit as the first; a solve
  leaves its last shadow direction pl behind.
* The spans: one ``lilac.solver.step`` and one ``lilac.solver.test`` an
  iteration, two ``lilac.operator.matvec`` in each step, one of them
  holding a ``lilac.operator.adjoint``; a plan built is a
  ``lilac.build.plan.route``, a plan read is none; nothing is recorded,
  and no range is made, without a profiler. NPB's factored path keeps its
  span counts (tests/test_torch_spans.py).
"""

import collections
import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lilac_tpu_torch.formats.convert import length_relabel_csr
from lilac_tpu_torch.generate.random_crs import random_crs
from lilac_tpu_torch.plan import SpmvPlan
from lilac_tpu_torch.solvers.bicg import bicg_solve
from lilac_tpu_torch.utils import profiling
from lilac_tpu_torch.workloads import sparsebench as tsb

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from portbench.reference import sparsebench as ref  # noqa: E402

torch.set_num_threads(1)

HIST_FIRST = 20
MAXIT = 30


@pytest.fixture
def hier(tmp_path, monkeypatch):
    monkeypatch.setenv("LILAC_DATA_DIR", str(tmp_path))
    monkeypatch.setenv("LILAC_HIER_BL", "256")
    for k in ("LILAC_SB_TRANSPOSE", "LILAC_HIER_GMAX"):
        monkeypatch.delenv(k, raising=False)
    return tmp_path


def _solver(size, dtype, maxit=MAXIT):
    return tsb.BenchSolver(size, maxit=maxit, dtype=dtype, kernel="routed_hier",
                           device="cpu")


def _b(n, seed):
    return np.random.default_rng(seed).uniform(0.5, 1.5, n).astype(np.float32).astype(
        np.float64)


# -- the reference's matrix and numbering ----------------------------------------


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("size", [8, 10, 12])
def test_reference_generator_and_sigma_are_the_programs(size, seed):
    got, want = ref.random_crs(size, seed), random_crs(size, seed)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert got[3] == want[3]
    order = length_relabel_csr(*want)[3]
    assert np.array_equal(ref.relabel(got[0]), order)


def test_reference_transpose():
    indptr, indices, data, (n, _) = ref.random_crs(8, 5)
    dense = np.zeros((n, n))
    dense[np.repeat(np.arange(n), np.diff(indptr)), indices] = data
    t_ptr, t_ix, t_v = ref.transpose_csr(indptr, indices, data, n)
    dense_t = np.zeros((n, n))
    dense_t[np.repeat(np.arange(n), np.diff(t_ptr)), t_ix] = t_v
    assert np.array_equal(dense_t, dense.T)
    op = ref.Operator((indptr, indices, data, (n, n)), "cpu")
    u = torch.as_tensor(_b(n, 1))
    assert torch.allclose(op.matvec_t(u), torch.as_tensor(dense.T) @ u, rtol=1e-14)


# -- the program against the reference ---------------------------------------------


@pytest.mark.parametrize("size", [10, 12])
@pytest.mark.parametrize("dtype", ["df64", "f64"])
def test_bicg_agrees_with_the_reference(hier, dtype, size):
    sol = _solver(size, dtype)
    assert sol.plan.kernel == ("routed_hier_df" if dtype == "df64" else "routed_hier")
    assert sol.plan_t is None  # sb_transpose auto = adj: the plan in reverse
    b_prog = _b(sol.n, size)
    x, its, hist, rn = sol.solve(sol.plan.vec_in(b_prog))

    csr = ref.random_crs(size)
    sigma = ref.relabel(csr[0])
    op = ref.Operator(csr, "cpu")
    b = np.empty(sol.n)
    b[sigma] = b_prog  # program position k holds row sigma[k]
    b = torch.as_tensor(b)
    _, its_ref, hist_ref = ref.bicg(op, b, MAXIT)
    assert its == its_ref == -MAXIT
    rel = np.abs(hist.numpy()[:HIST_FIRST] - hist_ref[:HIST_FIRST]) / hist_ref[:HIST_FIRST]
    assert rel.max() <= 1e-7
    xo = np.empty(sol.n)
    xo[sigma] = sol.plan.vec_out(x)
    true_res = ref.residual_norm(op, b, torch.as_tensor(xo))
    gap = abs(true_res - float(sol.alg.to_f64(rn))) / true_res
    assert gap <= (1e-12 if dtype == "df64" else 1e-14)


def test_bicg_with_a_transpose_that_is_a_reads_apart(hier):
    """SparseBench's own substitution of A for Aᵀ (random.f:72) leaves the
    reference by far more than the tolerance above."""
    sol = _solver(10, "df64", maxit=HIST_FIRST)
    sol.matvec_t = sol.matvec
    _, _, hist, _ = sol.solve(sol.plan.vec_in(np.ones(sol.n)))
    csr = ref.random_crs(10)
    ones = torch.ones(sol.n, dtype=torch.float64)
    _, _, hist_ref = ref.bicg(ref.Operator(csr, "cpu"), ones, HIST_FIRST)
    assert (np.abs(hist.numpy() - hist_ref) / hist_ref).max() > 1e-3


def test_repeat_solves_are_bit_identical(hier):
    sol = _solver(10, "df64")
    b = sol.plan.vec_in(_b(sol.n, 2))
    first, second = sol.solve(b), sol.solve(b)
    assert first[1] == second[1]
    assert torch.equal(first[2], second[2])
    for u, v in ((first[0], second[0]), (first[3], second[3])):
        assert torch.equal(u.hi, v.hi) and torch.equal(u.lo, v.lo)


def test_a_plan_read_from_its_file_generates_no_matrix(hier, monkeypatch):
    """A second solver of the matrix reads the routed plan and the meta file
    beside it and neither generates nor relabels the matrix; it solves bit
    for bit as the first, and makes the host CSR only when asked for it."""
    import lilac_tpu_torch.generate.random_crs as gen_mod

    first = _solver(10, "df64")
    b = first.plan.vec_in(_b(first.n, 5))
    want = first.solve(b)

    def no_generation(*a, **k):
        raise AssertionError("the matrix was generated")

    monkeypatch.setattr(gen_mod, "random_crs", no_generation)
    second = _solver(10, "df64")
    assert (second.n, second.nnz, second.plan.row_stats, second.plan.kernel) == (
        first.n, first.nnz, first.plan.row_stats, first.plan.kernel)
    got = second.solve(b)
    assert got[1] == want[1] and torch.equal(got[2], want[2])
    for u, v in ((got[0], want[0]), (got[3], want[3])):
        assert torch.equal(u.hi, v.hi) and torch.equal(u.lo, v.lo)
    with pytest.raises(AssertionError, match="generated"):
        _ = second.host_csr
    monkeypatch.undo()
    for u, v in zip(second.host_csr[:3], first.host_csr[:3]):
        assert np.array_equal(u, v)
    with pytest.raises(ValueError, match="routed"):
        SpmvPlan.read("x", (4, 4), first.plan.row_stats, kernel="xla_ell", device="cpu")
    assert SpmvPlan.read("none_such", (4, 4), first.plan.row_stats, dtype="df64",
                         device="cpu") is None


def test_a_missing_plan_file_is_built_again(hier):
    build = profiling.BUILD
    _solver(10, "f64")
    for name in os.listdir(hier):
        if name.endswith(".npz"):
            os.remove(os.path.join(hier, name))
    routes = build.counts.get("lilac.build.plan.route", 0)
    sol = _solver(10, "f64")
    assert build.counts["lilac.build.plan.route"] == routes + 1
    assert sol.plan.kernel == "routed_hier" and sol._host_csr is not None


def test_the_solver_keeps_the_last_shadow_direction(hier):
    """`pl` after a solve is bicg_solve's last pl: the input of the solve's
    last transpose product."""
    sol = _solver(10, "df64")
    b = sol.plan.vec_in(_b(sol.n, 6))
    for stop_at in (4, None):
        sol.solve(b, stop_at=stop_at)
        state = bicg_solve(sol.matvec, sol.matvec_t, sol.alg, sol.As, b, sol.x0,
                           maxit=MAXIT, rtol=sol.rtol, stop_at=stop_at)[4]
        assert torch.equal(sol.pl.hi, state[4].hi) and torch.equal(sol.pl.lo, state[4].lo)
        assert bool(sol.pl.hi.abs().sum() > 0)


def test_benchmark_times_the_bench_solvers_solve(hier):
    r = tsb.benchmark(10, maxit=MAXIT, dtype="df64", kernel="routed_hier", device="cpu")
    sol = _solver(10, "df64")  # the plan file is read this time
    x, its, hist, rn = sol.solve(sol.plan.vec_in(np.ones(sol.n)))
    assert r.iterations == its and r.kernel == "routed_hier_df" and r.validated
    assert np.array_equal(r.hist, hist.numpy())
    assert r.residual == float(sol.alg.to_f64(rn))
    assert r.mflop_rate == sol.flops(its) / r.time_s / 1e6
    assert sol.flops(its) == MAXIT * (4.0 * sol.nnz + 10.0 * sol.n) + 2.0 * sol.nnz


# -- spans ---------------------------------------------------------------------------


def _spans(prof):
    """The lilac. events of a profile as (name, parent name), the parent
    being the innermost lilac. event that encloses it."""
    evs = sorted(
        ((e.name(), e.start_ns(), e.end_ns())
         for e in prof.profiler.kineto_results.events()
         if e.name().startswith("lilac.")),
        key=lambda e: (e[1], -e[2]))
    out, stack = [], []
    for e in evs:
        while stack and stack[-1][2] < e[2]:
            stack.pop()
        out.append((e[0], stack[-1][0] if stack else None))
        stack.append(e)
    return out


@pytest.mark.parametrize("dtype", ["df64", "f64"])
def test_each_iteration_records_its_spans(hier, dtype):
    sol = _solver(10, dtype)
    b = sol.plan.vec_in(np.ones(sol.n))
    plain = sol.solve(b, stop_at=3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = sol.solve(b, stop_at=3)
    spans = _spans(prof)
    count = collections.Counter(name for name, _ in spans)
    assert count["lilac.solver.step"] == count["lilac.solver.test"] == 3
    assert count["lilac.operator.adjoint"] == 3
    # two products a step, and r0 = A x0 - b before the first
    assert count["lilac.operator.matvec"] == 7
    assert collections.Counter(p for name, p in spans
                               if name == "lilac.operator.matvec") == {
        "lilac.solver.step": 6, None: 1}
    parents = {"lilac.solver.step": {None}, "lilac.solver.test": {"lilac.solver.step"},
               "lilac.operator.adjoint": {"lilac.operator.matvec"}}
    for name, parent in spans:
        if name in parents:
            assert parent in parents[name], (name, parent)
    assert count["lilac.kernels.route"] > 0
    assert (count["lilac.kernels.mulred"] > 0) == (dtype == "df64")
    # the profiler changes no bit
    assert plain[1] == traced[1] and torch.equal(plain[2], traced[2])
    assert np.array_equal(sol.plan.vec_out(plain[0]), sol.plan.vec_out(traced[0]))


def test_no_range_is_constructed_without_a_profiler(hier, monkeypatch):
    sol = _solver(10, "df64")

    class Raises:
        def __init__(self, *a, **k):
            raise AssertionError("a profiler range was constructed")

    monkeypatch.setattr(profiling, "_Range", Raises)
    b = sol.plan.vec_in(np.ones(sol.n))
    _, its, hist, _ = sol.solve(b, stop_at=3)
    assert its == -3 and bool(torch.isfinite(hist[:3]).all())
    sol.matvec_t(sol.As, b)
    with pytest.raises(AssertionError, match="range was constructed"):
        with profile(activities=[ProfilerActivity.CPU]):
            sol.solve(b, stop_at=1)


def test_a_plan_built_is_a_route_span_and_a_plan_read_is_not(hier):
    build = profiling.BUILD
    routes = build.counts.get("lilac.build.plan.route", 0)
    reads = build.counts.get("lilac.build.plan.read", 0)
    _solver(10, "df64")
    assert build.counts.get("lilac.build.plan.route", 0) == routes + 1
    assert build.counts.get("lilac.build.plan.read", 0) == reads
    _solver(10, "df64")
    assert build.counts.get("lilac.build.plan.route", 0) == routes + 1
    assert build.counts["lilac.build.plan.read"] == reads + 1
