"""The harness driven on the CPU at NPB class S, the look for a card
skipped: its result line, its files found by name, its faults and its
control judged not correct, and the modules a run loads."""

import json
import os
import subprocess
import sys

import pytest

import pb_support
from pb_support import REPO, result, run_cpu

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_no_card_exits_without_a_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "npb-cg-C.df64", "--seed", "1",
         "--seconds", "1", "--trace", "0"], cwd=REPO, capture_output=True, text=True)
    assert proc.returncode == 2
    assert proc.stdout.strip() == ""


@pytest.mark.parametrize("dtype", ["df64", "f64"])
def test_a_sound_run_is_correct(dtype, checkout_df64, checkout_f64):
    root = checkout_df64 if dtype == "df64" else checkout_f64
    proc = run_cpu(root, f"npb-cg-S.{dtype}", seed=2**31 + 12345)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = result(proc)
    assert list(res)[:5] == KEYS and list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    # peak_mem_gib has nothing to read off the card
    assert set(res["metrics"]) == {"mops", "setup_s"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    # the numbers compared, beside their limits, end standard error
    tail = proc.stderr.strip().splitlines()[-len(res["checks"]):]
    assert [line.split()[1] for line in tail] == list(res["checks"])
    assert all(" limit " in line for line in tail)


def test_new_files_are_found_without_edits(checkout_f64):
    """A configuration, a traffic mix, a cell (pb_support.make_checkout)
    and a per-layer metric added as files: the harness finds them by their
    names in BENCHMARK.json."""
    root = checkout_f64
    with open(os.path.join(root, "portbench", "metrics", "probe.steps.py"), "w") as f:
        f.write("def read(r):\n    return r.counts.get('window_steps')\n")
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["per_layer"].append({
        "name": "probe.steps", "unit": "steps", "better": "higher",
        "source": "host_clock", "layer": "solver", "moves": "mops",
        "workloads": ["npb-cg-S.f64"]})
    with open(path, "w") as f:
        json.dump(bench, f)
    proc = run_cpu(root, "npb-cg-S.f64", seed=5, trace=1)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = result(proc)
    assert res["correct"] is True
    assert res["metrics"]["probe.steps"]["value"] == res["attempted"]
    # per-layer metrics only: nothing of the card is read on the CPU
    assert "mops" not in res["metrics"]
    assert "solver.launches_per_step" not in res["metrics"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


# Faults planted in the program, each where its answer is produced.
FAULTS = {
    # a chunk of steps hands back the state it was given
    "state_unchanged": """
import lilac_tpu_torch.solvers.cg as cg
_real = cg.npb_power_method
def _fault(mv, alg, A, x0, shift, n, cgitmax=25):
    z, r, x = _real(mv, alg, A, x0, shift, n, cgitmax)
    return z, r, x0
cg.npb_power_method = _fault
""",
    # the operator's product leaves the second half of its rows out
    "half_the_rows": """
import lilac_tpu_torch.plan as plan
_real = plan.FactoredNPBPlan.matvec_with
def _half(y):
    y = y.clone()
    y[y.shape[0] // 2:] = 0
    return y
def _fault(self, A, x):
    y = _real(self, A, x)
    return type(y)(*[_half(t) for t in y]) if isinstance(y, tuple) else _half(y)
plan.FactoredNPBPlan.matvec_with = _fault
""",
    # one step's zeta altered where the solver produces it
    "zeta_altered": """
import lilac_tpu_torch.solvers.cg as cg
_real = cg.npb_power_method
def _fault(mv, alg, A, x0, shift, n, cgitmax=25):
    z, r, x = _real(mv, alg, A, x0, shift, n, cgitmax)
    return alg.add(z, alg.scalar(1e-7)), r, x
cg.npb_power_method = _fault
""",
    # one entry of the last x altered
    "x_altered": """
import lilac_tpu_torch.solvers.cg as cg
_real = cg.npb_power_method
def _fault(mv, alg, A, x0, shift, n, cgitmax=25):
    z, r, x = _real(mv, alg, A, x0, shift, n, cgitmax)
    h = x[0] if isinstance(x, tuple) else x
    h = h.clone()
    h[7] *= 1 + 1e-6
    return z, r, (type(x)(h, x[1]) if isinstance(x, tuple) else h)
cg.npb_power_method = _fault
""",
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_is_not_correct(fault, checkout_df64):
    proc = run_cpu(checkout_df64, "npb-cg-S.df64", seed=3, patch=FAULTS[fault])
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = result(proc)
    assert res["correct"] is False and res["failed"] >= 1


def test_the_control_is_not_correct(tmp_path):
    """The control: the program's own float32 path, judged by the df64
    cell's limits."""
    root = pb_support.make_checkout(tmp_path, "f32", "npb-cg-C.df64")
    proc = run_cpu(root, "npb-cg-S.f32", seed=4)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = result(proc)
    assert res["correct"] is False
    checks = res["checks"]
    assert checks["zeta_rel"]["value"] > checks["zeta_rel"]["limit"]


def test_a_run_loads_no_jax(checkout_f64):
    """lilac_tpu_torch is loaded and allowed (names are compared whole); a
    module named jax makes the run print no result and exit 3."""
    ok = run_cpu(checkout_f64, "npb-cg-S.f64", seed=6, patch="import lilac_tpu_torch")
    assert ok.returncode == 0 and result(ok)["correct"] is True
    bad = run_cpu(checkout_f64, "npb-cg-S.f64", seed=6,
                  patch="import types; sys.modules['jax'] = types.ModuleType('jax')")
    assert bad.returncode == 3
    assert bad.stdout.strip() == ""
    assert "jax" in bad.stderr


def test_a_checkouts_first_run_is_cold(tmp_path):
    """The first run of a cell in a checkout builds its plan file and says
    so; the next run loads it and is warm."""
    root = pb_support.make_checkout(tmp_path, "f64", "npb-cg-C.f64")
    first = run_cpu(root, "npb-cg-S.f64", seed=8)
    second = run_cpu(root, "npb-cg-S.f64", seed=9)
    assert first.returncode == 0 and second.returncode == 0, second.stderr[-3000:]
    assert result(first)["cold"] is True and result(second)["cold"] is False
    assert list(result(second))[-2:] == ["cold", "checks"]
