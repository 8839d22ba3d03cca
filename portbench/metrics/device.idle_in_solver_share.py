"""Share of the device's idle time in the profiled outer steps during which
the host was in the solver's own work: each idle gap between the first and
the last device operation is put down to the innermost lilac. span that
covers the gap's middle on the host, and the share is the idle time whose
span is a lilac.solver.* one (under a solver span and under no operator
span) over all the idle time."""

from portbench.yardstick import spans


def read(r):
    t = r.traces.get("steps")
    if t is None or not t.device_ops or not spans.has_spans(t):
        return None
    by = spans.idle_by_span(t)
    idle = sum(by.values())
    if idle <= 0:
        return 0.0
    solver = sum(s for name, s in by.items()
                 if name is not None and name.startswith("lilac.solver."))
    return solver / idle
