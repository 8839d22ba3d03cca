"""CUDA kernel launches (copies and sets not counted) in the profiled outer
steps, per step."""


def read(r):
    t = r.traces.get("steps")
    if t is None or not t.kernels:
        return None
    return len(t.kernels) / r.counts["profiled_steps"]
