"""1 - the union of the device operations' intervals in the profiled steps
over the untraced wall of as many steps, timed just before them."""

from portbench.yardstick.trace import union_seconds


def read(r):
    t = r.traces.get("steps")
    if t is None or not t.device_ops:
        return None
    return 1.0 - union_seconds(t.device_ops) / r.spans["steps_untraced"]
