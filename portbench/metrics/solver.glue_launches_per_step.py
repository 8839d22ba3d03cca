"""Kernel launches the solver issues itself in the profiled outer steps,
per step: the host's launch events inside the program's lilac.solver.step
spans and outside its lilac.operator.matvec spans (the df64 or f64 vector
chains of the CG loop), over the number of step spans."""

from portbench.yardstick import spans


def read(r):
    t = r.traces.get("steps")
    if t is None or not t.device_ops:
        return None
    steps = spans.intervals(t, "lilac.solver.step")
    if len(steps) == 0:
        return None
    glue = spans.launches_inside(t, "lilac.solver.step", "lilac.operator.matvec")
    return glue / len(steps)
