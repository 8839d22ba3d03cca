"""Device traces from torch.profiler, reduced to what the per-layer
metrics and the result's breakdown read.

A trace keeps the device operations (kernels, copies, sets) and the host
operations as (name, start, end) in seconds on the profiler's clock, the
host-clock wall of the traced call, and the spans the benchmark marked with
``record_function`` (names starting with ``portbench.``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Tuple

import numpy as np

MARK = "portbench."
NAME_CHARS = 160  # of a kernel's name, enough to tell templates apart

Interval = Tuple[str, float, float]


@dataclasses.dataclass
class Trace:
    device_ops: List[Interval]
    host_ops: List[Interval]
    marks: Dict[str, List[Tuple[float, float]]]
    wall_s: float

    @property
    def kernels(self) -> List[Interval]:
        """Device operations that are kernel launches (not copies or sets)."""
        return [op for op in self.device_ops
                if not op[0].startswith(("Memcpy", "Memset"))]

    def ops_within(self, lo: float, hi: float) -> List[Interval]:
        return [op for op in self.device_ops if op[1] >= lo and op[2] <= hi]


def _is_device(ev) -> bool:
    return "cuda" in str(getattr(ev, "device_type", "")).lower()


def profile(fn: Callable[[], object], sync: Callable[[], None]) -> Trace:
    """Run fn under torch.profiler (host and CUDA activity), synchronised
    before and after; the wall is the host clock around fn and the sync."""
    from torch.profiler import ProfilerActivity, profile as _profile

    acts = [ProfilerActivity.CPU]
    import torch

    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    sync()
    with _profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    device, host, marks = [], [], {}
    for ev in prof.events():
        tr = ev.time_range
        item = (ev.name[:NAME_CHARS], tr.start * 1e-6, tr.end * 1e-6)
        if ev.name.startswith(MARK):
            # a mark is also recorded as a device annotation spanning the
            # device work it covers: that copy is no device operation
            if not _is_device(ev):
                marks.setdefault(ev.name[len(MARK):], []).append(item[1:])
        elif _is_device(ev):
            device.append(item)
        else:
            host.append(item)
    device.sort(key=lambda op: op[1])
    return Trace(device, host, marks, wall)


def union_seconds(ops) -> float:
    """Seconds covered by at least one of the intervals."""
    if not ops:
        return 0.0
    iv = np.array([(a, b) for _, a, b in ops], dtype=np.float64)
    iv = iv[np.argsort(iv[:, 0])]
    ends = np.maximum.accumulate(iv[:, 1])
    # an interval starts a new run where it begins after every earlier end
    new = np.ones(len(iv), dtype=bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    run_end = np.append(ends[np.flatnonzero(new)[1:] - 1], ends[-1])
    return float(np.sum(run_end - starts))


def top_device_ops(trace: Trace, k: int = 10) -> List[list]:
    """The k device operations that took the most time, summed by name."""
    by = {}
    for name, a, b in trace.device_ops:
        by[name] = by.get(name, 0.0) + (b - a)
    return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:k]]


def idle_gaps(trace: Trace, k: int = 10) -> List[list]:
    """The device's idle time between its first and last operation, summed
    by the host operation running through each gap (the latest-started one
    that covers the gap's middle; "host" where none does), the k largest."""
    ops = trace.device_ops
    if len(ops) < 2:
        return []
    ends = np.maximum.accumulate(np.array([b for _, _, b in ops]))
    starts = np.array([a for _, a, _ in ops])
    gap_lo, gap_hi = ends[:-1], starts[1:]
    host = sorted(trace.host_ops, key=lambda op: op[1])
    by = {}
    stack, j = [], 0
    for i in np.flatnonzero(gap_hi > gap_lo):  # gaps in time order
        mid = 0.5 * (gap_lo[i] + gap_hi[i])
        while j < len(host) and host[j][1] <= mid:
            stack.append(host[j])
            j += 1
        while stack and stack[-1][2] < mid:
            stack.pop()
        label = stack[-1][0] if stack else "host"
        by[label] = by.get(label, 0.0) + float(gap_hi[i] - gap_lo[i])
    return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:k]]
