"""Kernel launches the operator issues itself, per product of the profiled
outer steps: the host's launch events inside the program's
lilac.operator.matvec spans and outside its lilac.kernels.* spans (the
df64 glue of the factored product: the s and d0 terms, the adjoint's
expand, TwoProd and sum over nets), over the number of matvec spans."""

from portbench.yardstick import spans


def read(r):
    t = r.traces.get("steps")
    if t is None or not t.device_ops:
        return None
    matvecs = spans.intervals(t, "lilac.operator.matvec")
    if len(matvecs) == 0:
        return None
    glue = spans.launches_inside(t, "lilac.operator.matvec", "lilac.kernels.")
    return glue / len(matvecs)
