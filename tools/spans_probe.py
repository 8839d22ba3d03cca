"""What the program's spans (lilac_tpu_torch.utils.profiling.span) cost and
what the profiler records for them, on a CUDA card.

    python3 tools/spans_probe.py                 # cost and annotation checks
    python3 tools/spans_probe.py npb-cg-C.df64   # and one benchmark cell

Prints one JSON object a line:

* ``cost``: ns of entering and leaving one span with no profiler running
  (the spans' every-day cost), and of the public record_function for
  comparison;
* ``annotations``: the device-side events a profiler records under a span
  and under a record_function range around the same kernel; a span must
  draw none (the benchmark's trace reader would count one as a device
  operation);
* per cell named: the cell set up as the benchmark sets it up
  (portbench/run.py's environment and caches), 2 s of window, its traced
  phase, the five span-reading metrics and the spans passed a step by
  name, the host's launch events inside the step spans against the
  kernels the device ran, the kernels whose launch left no host event (by
  correlation id, one outer step profiled again), the device's idle time by
  innermost span, and the comparison with the reference.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cost(n: int = 1_000_000) -> dict:
    import torch

    from lilac_tpu_torch.utils import profiling

    s = profiling.span("lilac.probe.cost")

    def loop(ctx):
        t0 = time.perf_counter()
        for _ in range(n):
            with ctx:
                pass
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    for _ in range(n):
        pass
    empty = time.perf_counter() - t0
    span_ns = min(loop(s) for _ in range(3)) - empty
    rf = 100_000
    t0 = time.perf_counter()
    for _ in range(rf):
        with torch.profiler.record_function("probe"):
            pass
    rf_ns = (time.perf_counter() - t0) / rf * 1e9
    return {"span_ns": span_ns / n * 1e9, "record_function_ns": rf_ns}


def annotations() -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lilac_tpu_torch.utils import profiling

    x = torch.ones(1 << 20, device="cuda")
    s = profiling.span("lilac.probe.span")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with s:
            x.add_(1)
        with torch.profiler.record_function("probe.record_function"):
            x.add_(1)
        torch.cuda.synchronize()
    out = {}
    for ev in prof.events():
        if ev.name.startswith(("lilac.probe", "probe.")):
            dev = "cuda" in str(ev.device_type).lower()
            key = f"{ev.name}:{'device' if dev else 'host'}"
            out[key] = {"count": out.get(key, {}).get("count", 0) + 1,
                        "is_user_annotation": bool(ev.is_user_annotation)}
    return out


def _uncorrelated(step) -> dict:
    """Kernels of one profiled call of `step` whose correlation id no host
    event carries, by name: their launch left no host event."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    host, kernels = set(), []
    for e in prof.profiler.kineto_results.events():
        dev = "cuda" in str(e.device_type()).lower()
        if dev and not e.name().startswith(("Memcpy", "Memset")):
            kernels.append((e.name(), e.correlation_id()))
        elif not dev:
            host.add(e.correlation_id())
    missing = {}
    for name, cid in kernels:
        if cid not in host or cid == 0:
            missing[name[:100]] = missing.get(name[:100], 0) + 1
    return {"kernels": len(kernels), "without_host_event": missing}


def cell(name: str, device: str = "cuda") -> dict:
    import collections

    import torch

    from portbench import harness
    from portbench import run as pb_run
    from portbench.yardstick import spans
    from portbench.yardstick import trace as _trace

    pb_run.pin_environment()
    from lilac_tpu_torch.utils import profiling

    profiling.BUILD.__init__()  # this cell's set-up alone

    c = harness.load_cell(name)
    on_card = device.startswith("cuda")
    r = harness.Readings(on_card=on_card)
    drv = harness.driver(c.config["kind"])
    t0 = time.perf_counter()
    run = drv.Run(c, 2**31 + 77, device, r)
    run._sync()
    setup = time.perf_counter() - t0
    run.window(2.0)
    run.trace()
    t = r.traces["steps"]
    n = r.counts["profiled_steps"]
    metrics = {m: harness.reader(m)(r) for m in (
        "solver.launches_per_step", "device.idle_share",
        "solver.glue_launches_per_step", "solver.glue_host_ms_per_step",
        "operator.glue_launches_per_matvec", "device.idle_in_solver_share",
        "host_build.plan_read_s")}
    names = collections.Counter(op[0] for op in t.host_ops if op[0].startswith("lilac."))
    launches = spans.launch_times(t)
    steps = spans.intervals(t, "lilac.solver.step")
    in_steps = int(spans.covered(launches, steps).sum())
    lo, hi = steps[:, 0].min(), steps[:, 1].max()
    # device time runs behind the host's: a step's kernels end up to its
    # last launch's queueing later, so count those after the first step's
    # start, all of which the steps launched
    kernels_in_steps = sum(1 for k in t.kernels if k[1] >= lo)

    def one_step():
        run._steps(run.x, 1)

    out = {
        "cell": name, "setup_s": setup, "profiled_steps": n,
        "metrics": metrics,
        "spans_a_step": {k: v / n for k, v in sorted(names.items())},
        "spans_a_step_total": sum(names.values()) / n,
        "launch_events_in_steps_a_step": in_steps / n,
        "kernels_in_steps_a_step": kernels_in_steps / n,
        "lilac_device_ops": sorted({op[0] for op in t.device_ops
                                    if op[0].startswith("lilac.")}),
        "steps_untraced_s": r.spans["steps_untraced"], "steps_traced_wall_s": t.wall_s,
        "busy_s": _trace.union_seconds(t.device_ops),
        "idle_by_span_s": sorted(([k, v] for k, v in spans.idle_by_span(t).items()),
                                 key=lambda kv: -kv[1])[:12],
        "idle_gaps_breakdown": _trace.idle_gaps(t),
        "build": dict(profiling.BUILD.total),
        "build_report": profiling.BUILD.report(),
        "one_step": _uncorrelated(one_step) if on_card else None,
    }
    v = run.check()
    out["correct"] = v.correct
    out["checks"] = {ch.name: ch.value for ch in v.checks}
    return out


def main(argv) -> int:
    import torch

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    emit({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})
    emit({"cost": cost()})
    emit({"annotations": annotations()})
    for name in argv[1:]:
        emit(cell(name))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
