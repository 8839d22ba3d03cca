"""Share (%) of the least time of one operator product that the device
takes for it: the operation's least bytes (yardstick/roofline.py) over the
card's published HBM bandwidth, against the device time of the operations
each profiled product launched (L2 flushed before each), averaged."""

from portbench.yardstick.trace import union_seconds


def read(r):
    t = r.traces.get("products")
    if t is None or r.peaks is None:
        return None
    spans = t.marks.get("product", [])
    busy = sum(union_seconds(t.ops_within(a, b)) for a, b in spans)
    if not spans or busy <= 0:
        return None
    least = r.counts["spmv_least_bytes"] / r.peaks["hbm_bytes_per_s"]
    return 100.0 * least / (busy / len(spans))
