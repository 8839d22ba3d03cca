"""The harness driven on the CPU through the configuration kind
``sparsebench_bicg`` at size 10 (n = 1000), the look for a card skipped:
SparseBench's timed BiCG through ``BenchSolver`` on a forced hierarchical
routed plan (bl = 256: K3-K5 and K7-K9 through their plain versions), the
cell's own limits. A sound run reads correct; the control (the program's
float32 path) and three faults planted in the program read not correct.
The readers of the three metrics the configuration adds read None on an
NPB-shaped run and numbers on a hand-built trace."""

import json
import os
import shutil

import pytest

from pb_support import BENCH, REPO, result, run_cpu
from portbench.harness import Readings, reader
from portbench.yardstick import csr_roofline
from portbench.yardstick.trace import Trace

CELL = "sparsebench-160.df64"
# the hierarchical path at a size the CPU runs: forced, with small blocks
HIER = "os.environ['LILAC_HIER_BL'] = '256'\n"


def make_checkout(root, dtype: str) -> str:
    """root/BENCHMARK.json and root/portbench/ (the benchmark's files
    copied), plus a configuration `sparsebench-10` (sparsebench-160's file
    at size 10, the hierarchical routed kernel forced), a traffic mix of
    `dtype` and the cell `sparsebench-10.<dtype>` with sparsebench-160's
    limits, its traced phase cut to 2 iterations and 2 products."""
    root = str(root)
    dst = os.path.join(root, "portbench")
    shutil.copytree(BENCH, dst, ignore=shutil.ignore_patterns("cache", "__pycache__"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(BENCH, "configs", "sparsebench-160.json")) as f:
        conf = json.load(f)
    conf.update(size=10, n=1000, impl="routed_hier")
    with open(os.path.join(BENCH, "traffic", "df64.bicg100.json")) as f:
        traffic = dict(json.load(f), dtype=dtype)
    with open(os.path.join(BENCH, "workloads", CELL + ".json")) as f:
        wl = dict(json.load(f), profile_steps=2, profile_products=2)
    cell, mix = f"sparsebench-10.{dtype}", f"{dtype}.bicg100"
    _write(os.path.join(dst, "configs", "sparsebench-10.json"), conf)
    _write(os.path.join(dst, "traffic", mix + ".json"), traffic)
    _write(os.path.join(dst, "workloads", cell + ".json"), wl)
    bench["configs"].append({"name": "sparsebench-10", "source": "SparseBench size 10",
                             "file": "portbench/configs/sparsebench-10.json",
                             "reduced": ["size"], "why": "tests"})
    bench["workloads"].append({"name": cell, "config": "sparsebench-10", "traffic": mix,
                               "chips": 1, "why": "tests"})
    for m in bench["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append(cell)
    _write(os.path.join(root, "BENCHMARK.json"), bench)
    return root


def _write(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return make_checkout(tmp_path_factory.mktemp("sb_df64"), "df64")


def test_a_sound_run_is_correct(checkout):
    proc = run_cpu(checkout, "sparsebench-10.df64", seed=2**31 + 777, seconds=0.1,
                   trace=1, patch=HIER)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = result(proc)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert list(res["checks"]) == ["its_diff", "hist_rel", "true_gap", "adj_rel"]
    # per-layer metrics only; of the card's, nothing is read on the CPU
    assert set(res["metrics"]) == {"host_build.plan_s"}
    assert {"busy_s", "window_s"} <= set(res["device"])


def test_seed_zero_solves_with_ones(checkout):
    """run_all's b = 1: BiCG does not converge in 100 iterations here
    either, and the run is judged correct."""
    proc = run_cpu(checkout, "sparsebench-10.df64", seed=0, seconds=0.1, patch=HIER)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = result(proc)
    assert res["correct"] is True
    assert set(res["metrics"]) == {"mops", "setup_s"}


# Faults planted in the program, each where its answer is produced, and
# the check that reads it.
FAULTS = {
    # Aᵀ replaced by A, as SparseBench's own driver does (random.f:72)
    "transpose_is_a": ("""
import lilac_tpu_torch.plan as plan
plan.SpmvPlan.matvec_t_with = lambda self, A, x: self.matvec_with(A, x)
""", "hist_rel"),
    # the fourth iteration's alpha update dropped: its sdiv gives 0
    "alpha_dropped": ("""
import lilac_tpu_torch.solvers.algebra as al
import lilac_tpu_torch.workloads.sparsebench as sb
_calls = [0]
_solve, _sdiv = sb.BenchSolver.solve, al.DF64Alg.sdiv
def _fault_solve(self, b, **kw):
    _calls[0] = 0
    return _solve(self, b, **kw)
def _fault_sdiv(self, a, b):
    _calls[0] += 1  # alpha, beta, alpha, beta, ...: call 7 is the 4th alpha
    q = _sdiv(self, a, b)
    return self.scalar(0.0) if _calls[0] == 7 else q
sb.BenchSolver.solve = _fault_solve
al.DF64Alg.sdiv = _fault_sdiv
""", "hist_rel"),
    # the adjoint product's lo words zeroed: Aᵀ pl in float32 alone
    "adjoint_lo_zeroed": ("""
import torch
import lilac_tpu_torch.plan as plan
_real = plan.SpmvPlan.matvec_t_with
def _fault(self, A, x):
    y = _real(self, A, x)
    return type(y)(y.hi, torch.zeros_like(y.lo))
plan.SpmvPlan.matvec_t_with = _fault
""", "hist_rel"),
    # the same, from a solve's 31st transpose product on: past the norms
    # the history is held to, so only the product of the last pl reads it
    "late_adjoint_lo_zeroed": ("""
import torch
import lilac_tpu_torch.plan as plan
import lilac_tpu_torch.workloads.sparsebench as sb
_calls = [0]
_real, _solve = plan.SpmvPlan.matvec_t_with, sb.BenchSolver.solve
def _fault_solve(self, b, **kw):
    _calls[0] = 0
    return _solve(self, b, **kw)
def _fault(self, A, x):
    _calls[0] += 1
    y = _real(self, A, x)
    return type(y)(y.hi, torch.zeros_like(y.lo)) if _calls[0] > 30 else y
sb.BenchSolver.solve = _fault_solve
plan.SpmvPlan.matvec_t_with = _fault
""", "adj_rel"),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_is_not_correct(fault, checkout):
    patch, reads = FAULTS[fault]
    proc = run_cpu(checkout, "sparsebench-10.df64", seed=3, seconds=0.1,
                   patch=HIER + patch)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = result(proc)
    assert res["correct"] is False and res["failed"] >= 1
    checks = res["checks"]
    assert checks[reads]["value"] > checks[reads]["limit"]


def test_the_control_is_not_correct(tmp_path):
    """The control: the program's own float32 path, judged by the df64
    cell's limits."""
    root = make_checkout(tmp_path, "f32")
    proc = run_cpu(root, "sparsebench-10.f32", seed=4, seconds=0.1, patch=HIER)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = result(proc)
    assert res["correct"] is False
    checks = res["checks"]
    assert list(checks) == ["its_diff", "hist_rel", "true_gap", "adj_rel"]
    assert all(checks[k]["value"] > checks[k]["limit"]
               for k in ("hist_rel", "true_gap", "adj_rel"))


# -- the readers of the configuration's metrics ---------------------------------

MS = 1e-3
NEW = ("operator.adjoint_ms", "kernels.adjoint_roofline", "operator.adjoint_glue_launches")


def _trace(host, busy, launches=(), marks=None):
    host_ops = [(n, a * MS, b * MS) for n, a, b in host]
    host_ops += [("cudaLaunchKernel", t * MS, (t + 0.1) * MS) for t in launches]
    device = sorted(("kernel", a * MS, b * MS) for a, b in busy)
    marks = {k: [(a * MS, b * MS) for a, b in v] for k, v in (marks or {}).items()}
    return Trace(device_ops=device, host_ops=host_ops, marks=marks, wall_s=1.0)


def test_the_new_readers_read_none_on_an_npb_run():
    """An NPB step: matvec spans but no adjoint span, product marks but no
    adjoint marks, no adjoint timing."""
    r = Readings(on_card=True, peaks={"hbm_bytes_per_s": 3.35e12})
    r.spans["matvec_untraced"] = 1e-3
    r.counts["spmv_least_bytes"] = 1e6
    r.traces["steps"] = _trace([("lilac.solver.step", 0, 10), ("lilac.operator.matvec", 1, 5),
                                ("lilac.operator.VT", 3, 5)], [(0, 4), (6, 10)], (2, 4))
    r.traces["products"] = _trace([], [(0, 1)], marks={"product": [(0, 2)]})
    assert all(reader(m)(r) is None for m in NEW)
    assert all(reader(m)(Readings()) is None for m in NEW)


def test_the_new_readers_on_a_bicg_iteration():
    # one iteration: A p in a matvec span, then Aᵀ pl in a matvec span with
    # an adjoint span inside it; kernels route inside both
    host = [("lilac.solver.step", 0, 100),
            ("lilac.operator.matvec", 10, 30), ("lilac.kernels.route", 12, 28),
            ("lilac.operator.matvec", 40, 80), ("lilac.operator.adjoint", 40, 80),
            ("lilac.kernels.route", 50, 70), ("lilac.solver.test", 90, 95)]
    # launches 15, 55 in the kernels; 42, 45, 75 the adjoint's glue; 85 solver
    launches = (15, 42, 45, 55, 75, 85)
    r = Readings(on_card=True, peaks={"hbm_bytes_per_s": 2e6})
    r.traces["steps"] = _trace(host, [(0, 100)], launches)
    assert reader("operator.adjoint_glue_launches")(r) == 3.0
    assert reader("operator.glue_launches_per_matvec")(r) == 1.5
    assert reader("solver.glue_launches_per_step")(r) == 1.0
    # two marked transpose products of 4 ms and 6 ms of device time: 5 ms
    # each against a least time of 1e4 bytes / 2e6 bytes/s = 5 ms
    r.counts["adjoint_least_bytes"] = 1e4
    r.traces["products"] = _trace([], [(0, 4), (10, 16), (20, 21)],
                                  marks={"adjoint": [(0, 5), (10, 17)],
                                         "product": [(20, 22)]})
    assert reader("kernels.adjoint_roofline")(r) == pytest.approx(100.0)
    r.spans["adjoint_untraced"] = 2.5e-3
    assert reader("operator.adjoint_ms")(r) == pytest.approx(2.5)
    r.on_card = False  # a time off the card is no device metric
    assert reader("operator.adjoint_ms")(r) is None


def test_csr_least_bytes():
    # 3 rows, 5 entries, f64 words: 5 * 12 + 4 * 4 + 2 * 3 * 8
    assert csr_roofline.csr_spmv_bytes(3, 5, 8) == 60 + 16 + 48
    # sparsebench-160 in df64: 27.5 M entries, 4 096 000 rows
    assert csr_roofline.csr_spmv_bytes(4096000, 27500000, 8) == (
        27500000 * 12 + 4096001 * 4 + 2 * 4096000 * 8)

