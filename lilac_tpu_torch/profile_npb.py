"""Where one NPB CG outer step spends its time on the GPU.

    python -m lilac_tpu_torch.profile_npb [CLASS] [DTYPE]

Builds the factored plan (default class C, df64, routed), runs the untimed
warm-up, then traces one matvec and one outer step (25 CG iterations + the
residual matvec + the zeta update) with torch.profiler. Prints one JSON
object: CUDA kernel launches per matvec and per outer step, the device's
busy time against the wall time of the step (the rest is the device idle,
waiting for the host to enqueue), and the kernels that take most of the
device time. Needs a GPU.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time


def _trace(fn):
    """Run fn under the profiler: (wall seconds, {kernel: (count, us)})."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    for ev in prof.events():
        if getattr(ev, "device_type", None) is not None and "cuda" in str(
                ev.device_type).lower():
            c, us = kernels.get(ev.name, (0, 0.0))
            kernels[ev.name] = (c + 1, us + ev.device_time)
    return wall, kernels


def _summary(wall, kernels, top=20):
    launches = sum(c for c, _ in kernels.values())
    busy_us = sum(us for _, us in kernels.values())
    rows = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:top]
    return {
        "wall_ms": wall * 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": max(0.0, 1.0 - busy_us / 1e6 / wall) if wall else None,
        "launches": launches,
        "top_by_device_time": [
            {"kernel": name[:90], "count": c, "ms": us / 1e3} for name, (c, us) in rows],
    }


def main(argv) -> int:
    import numpy as np
    import torch

    from lilac_tpu_torch.generate.npb import CLASSES
    from lilac_tpu_torch.plan import FactoredNPBPlan
    from lilac_tpu_torch.solvers.algebra import get_algebra
    from lilac_tpu_torch.solvers.cg import npb_power_method

    if not torch.cuda.is_available():
        raise RuntimeError("profile_npb measures on a GPU and found none")
    class_name = argv[1] if len(argv) > 1 else "C"
    dtype = argv[2] if len(argv) > 2 else "df64"
    cls = CLASSES[class_name.upper()]
    plan = FactoredNPBPlan(class_name, dtype=dtype, device="cuda")
    alg = get_algebra(dtype, device="cuda")
    x0 = plan.vec_in(np.ones(cls.na, dtype=np.float64))

    def step():
        return npb_power_method(plan.matvec_with, alg, plan.A, x0, cls.shift, 1)

    step()  # warm-up: builds the kernels, fills the allocator's pools
    # untraced wall time of one outer step, for the profiler's own cost
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    untraced = time.perf_counter() - t0

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    out = {
        "card": card, "class": cls.name, "dtype": dtype, "kernel": plan.kernel,
        "factored_vt": plan.factored_vt,
        "outer_step_untraced_ms": untraced * 1e3,
        "matvec": _summary(*_trace(lambda: plan.matvec(x0))),
        "outer_step": _summary(*_trace(step)),
    }
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
