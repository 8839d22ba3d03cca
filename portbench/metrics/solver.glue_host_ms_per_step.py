"""Host milliseconds a profiled outer step spends in the solver's own work:
the time inside the program's lilac.solver.step spans less the union of
the lilac.operator.matvec spans within them, per step span. Read under the
profiler, so it carries the profiler's own cost."""

from portbench.yardstick import spans


def read(r):
    t = r.traces.get("steps")
    if t is None or not t.device_ops:
        return None
    steps = spans.intervals(t, "lilac.solver.step")
    if len(steps) == 0:
        return None
    inside = float(sum(b - a for a, b in spans.merged(steps)))
    matvec = spans.seconds_within(spans.intervals(t, "lilac.operator.matvec"), steps)
    return 1e3 * (inside - matvec) / len(steps)
