"""Share (%) of the least time of one transpose product y = Aᵀ u that the
device takes for it: the product's least bytes (yardstick/csr_roofline.py)
over the card's published HBM bandwidth, against the device time of the
operations each profiled transpose product launched (L2 flushed before
each), averaged. None where the configuration runs no transpose product."""

from portbench.yardstick.trace import union_seconds


def read(r):
    t = r.traces.get("products")
    if t is None or r.peaks is None or "adjoint_least_bytes" not in r.counts:
        return None
    spans = t.marks.get("adjoint", [])
    busy = sum(union_seconds(t.ops_within(a, b)) for a, b in spans)
    if not spans or busy <= 0:
        return None
    least = r.counts["adjoint_least_bytes"] / r.peaks["hbm_bytes_per_s"]
    return 100.0 * least / (busy / len(spans))
