"""The benchmark's general part: it reads BENCHMARK.json, finds a cell's
files by name, runs the cell's driver and reduces its readings to metrics.

Files a cell is made of, each found by its name in BENCHMARK.json:

* ``configs/<config>.json`` (the path is the config entry's ``file``): the
  deployment's sizes; its ``kind`` names the driver;
* ``drivers/<kind>.py``: the code that builds, drives and checks that kind
  of configuration;
* ``traffic/<traffic>.json``: the mix the driver runs;
* ``workloads/<cell>.json``: what belongs to the cell alone (the sizes of
  its traced phase, the limits of its comparison);
* ``metrics/<metric>.py``: one reader a metric, ``read(readings)``
  returning a number or None (nothing to read in this run: the metric is
  left out of the line).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import time
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# where the program's kernel libraries and plan files are built and kept:
# a set-up that adds a file here built something, and its run is cold
BUILT = (os.path.join(HERE, "cache"), os.path.join(ROOT, "build"))


@dataclasses.dataclass
class Readings:
    """What one run measured, for the metric readers. Host-clock spans in
    seconds; traces from yardstick.trace; counts are plain numbers."""

    setup_s: Optional[float] = None
    window_s: Optional[float] = None
    window_ops: Optional[float] = None
    peak_bytes: Optional[int] = None
    spans: Dict[str, float] = dataclasses.field(default_factory=dict)
    counts: Dict[str, float] = dataclasses.field(default_factory=dict)
    traces: Dict[str, object] = dataclasses.field(default_factory=dict)
    on_card: bool = False
    peaks: Optional[dict] = None


@dataclasses.dataclass
class Check:
    """One number the comparison with the reference judged."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit  # NaN fails


@dataclasses.dataclass
class Verdict:
    attempted: int
    failed: int
    checks: List[Check]

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(c.ok for c in self.checks)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration's file
    traffic: dict  # the traffic file
    workload: dict  # the cell's own file
    end_to_end: List[dict]  # the BENCHMARK.json entries this cell reports
    per_layer: List[dict]


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric["moves"] in reported


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell `name` of root/BENCHMARK.json with its files read."""
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, None)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, reported)]
    return Cell(
        name=name,
        chips=int(entry["chips"]),
        config=_load_json(os.path.join(root, conf["file"])),
        traffic=_load_json(os.path.join(HERE, "traffic", entry["traffic"] + ".json")),
        workload=_load_json(os.path.join(HERE, "workloads", name + ".json")),
        end_to_end=e2e,
        per_layer=per_layer,
    )


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str):
    return _module(os.path.join(HERE, "drivers", kind + ".py"),
                   "portbench_driver_" + kind.replace("-", "_").replace(".", "_"))


def reader(metric: str):
    mod = _module(os.path.join(HERE, "metrics", metric + ".py"),
                  "portbench_metric_" + metric.replace("-", "_").replace(".", "_"))
    return mod.read


def built_files(dirs=BUILT) -> set:
    """Every file under `dirs`."""
    found = set()
    for d in dirs:
        for base, _, names in os.walk(d):
            found.update(os.path.join(base, n) for n in names)
    return found


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float) -> dict:
    """Set the cell up, run its window, trace it if asked, judge it against
    the reference. `t_start` is the process's start on the host clock
    (time.perf_counter). Returns the result line's object; its "cold" is
    true where set-up built a kernel library or a plan file (a checkout's
    first run of the cell), so that run's setup_s can be set apart."""
    import torch

    from portbench.yardstick import peaks as _peaks
    from portbench.yardstick import trace as _trace

    on_card = device.startswith("cuda")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    r = Readings(on_card=on_card)
    if on_card:
        r.peaks = _peaks.peaks_for(torch.cuda.get_device_name())
    drv = driver(cell.config["kind"])
    before = built_files()
    run = drv.Run(cell, seed, device, r)  # set-up, warm-up included
    if on_card:
        torch.cuda.synchronize()
    r.setup_s = time.perf_counter() - t_start
    cold = bool(built_files() - before)
    run.window(seconds)
    r.peak_bytes = int(torch.cuda.max_memory_allocated()) if on_card else 0
    if trace:
        run.trace()
    verdict = run.check()  # frees the program's state first

    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        v = reader(m["name"])(r)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name() if on_card else "cpu",
        "count": cell.chips if on_card else 0,
        "memory_peak_bytes": r.peak_bytes,
    }
    out = {
        "correct": verdict.correct,
        "attempted": verdict.attempted,
        "failed": verdict.failed,
        "metrics": metrics,
        "device": dev,
    }
    steps = r.traces.get("steps")
    if trace and steps is not None:
        dev["busy_s"] = _trace.union_seconds(steps.device_ops)
        dev["window_s"] = steps.wall_s
        out["breakdown"] = {
            "device_ops": _trace.top_device_ops(steps),
            "idle_gaps": _trace.idle_gaps(steps),
        }
    out["cold"] = cold
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in verdict.checks}
    return out
