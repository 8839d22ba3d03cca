"""The program's spans in a device trace, for the per-layer metrics that
read them.

The measured program marks its layer boundaries with host-only ranges
named ``lilac.<layer>.<what>`` (solver, operator, kernels), recorded on
the profiler's clock while a profiler records; they land among a Trace's
host operations. This module gives their intervals by name, the kernel
launches the host issued inside them, and the device's idle gaps put down
to the innermost span the host was in at each gap's middle. A program
without spans gives empty intervals, and the readers return None.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

PREFIX = "lilac."
# host events that launch a kernel; copies and sets are not launches
LAUNCHES = frozenset(("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                      "cuLaunchKernelEx"))


def intervals(trace, name: str) -> np.ndarray:
    """[k, 2] (start, end) seconds of the host ranges called `name`, or,
    for a name ending in ".", of every range whose name starts with it;
    sorted by start."""
    if name.endswith("."):
        iv = [(a, b) for n, a, b in trace.host_ops if n.startswith(name)]
    else:
        iv = [(a, b) for n, a, b in trace.host_ops if n == name]
    return np.array(sorted(iv), dtype=np.float64).reshape(-1, 2)


def merged(iv: np.ndarray) -> np.ndarray:
    """The union of intervals as disjoint [k, 2] runs, sorted."""
    if len(iv) == 0:
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), dtype=bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    run_end = np.append(ends[np.flatnonzero(new)[1:] - 1], ends[-1])
    return np.stack([starts, run_end], axis=1)


def covered(times: np.ndarray, iv: np.ndarray) -> np.ndarray:
    """Which of `times` lie inside the union of the intervals `iv`."""
    runs = merged(iv)
    if len(runs) == 0:
        return np.zeros(len(times), dtype=bool)
    k = np.searchsorted(runs[:, 0], times, side="right") - 1
    ok = k >= 0
    return ok & (times <= runs[np.maximum(k, 0), 1])


def seconds_within(iv: np.ndarray, outer: np.ndarray) -> float:
    """Seconds of the union of `iv` that lie inside the union of `outer`."""
    a, b = merged(iv), merged(outer)
    total, j = 0.0, 0
    for lo, hi in a:
        while j < len(b) and b[j, 1] <= lo:
            j += 1
        k = j
        while k < len(b) and b[k, 0] < hi:
            total += max(0.0, min(hi, b[k, 1]) - max(lo, b[k, 0]))
            k += 1
    return total


def launch_times(trace) -> np.ndarray:
    """Start times of the host's kernel launch events, sorted."""
    return np.sort(np.array([a for n, a, _ in trace.host_ops if n in LAUNCHES],
                            dtype=np.float64))


def launches_inside(trace, inside: str, outside: Optional[str] = None) -> int:
    """Launch events inside the spans `inside` and outside the spans
    `outside` (names as intervals() takes them)."""
    t = launch_times(trace)
    keep = covered(t, intervals(trace, inside))
    if outside is not None:
        keep &= ~covered(t, intervals(trace, outside))
    return int(np.count_nonzero(keep))


def idle_gaps(trace) -> np.ndarray:
    """[k, 2] the device's idle gaps between its first and last operation,
    in time order (as yardstick/trace.py:idle_gaps finds them)."""
    ops = trace.device_ops
    if len(ops) < 2:
        return np.zeros((0, 2))
    ends = np.maximum.accumulate(np.array([b for _, _, b in ops], dtype=np.float64))
    starts = np.array([a for _, a, _ in ops], dtype=np.float64)
    gaps = np.stack([ends[:-1], starts[1:]], axis=1)
    return gaps[gaps[:, 1] > gaps[:, 0]]


def idle_by_span(trace) -> Dict[Optional[str], float]:
    """Idle seconds of the device by the innermost program span covering
    each gap's middle on the host (None: under no span)."""
    spans = sorted(((n, a, b) for n, a, b in trace.host_ops if n.startswith(PREFIX)),
                   key=lambda s: (s[1], -s[2]))
    by: Dict[Optional[str], float] = {}
    stack: List[tuple] = []
    j = 0
    for lo, hi in idle_gaps(trace):
        mid = 0.5 * (lo + hi)
        while j < len(spans) and spans[j][1] <= mid:
            while stack and stack[-1][2] < spans[j][1]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][2] < mid:
            stack.pop()
        label = stack[-1][0] if stack else None
        by[label] = by.get(label, 0.0) + float(hi - lo)
    return by


def has_spans(trace) -> bool:
    return any(n.startswith(PREFIX) for n, _, _ in trace.host_ops)
