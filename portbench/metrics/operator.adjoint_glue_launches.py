"""Kernel launches the operator's transpose product issues itself, per
product of the profiled steps: the host's launch events inside the
program's lilac.operator.adjoint spans and outside its lilac.kernels.*
spans (the df64 glue of the adjoint: the expand to slots, the TwoProd,
the sum over nets), over the number of adjoint spans. None where the
program marks no adjoint."""

from portbench.yardstick import spans


def read(r):
    t = r.traces.get("steps")
    if t is None or not t.device_ops:
        return None
    adjoints = spans.intervals(t, "lilac.operator.adjoint")
    if len(adjoints) == 0:
        return None
    glue = spans.launches_inside(t, "lilac.operator.adjoint", "lilac.kernels.")
    return glue / len(adjoints)
