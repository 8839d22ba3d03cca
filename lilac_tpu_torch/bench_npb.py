"""Headline benchmark of the port: NPB CG time-to-solution on one GPU.

    python -m lilac_tpu_torch.bench_npb

Counterpart of the repo's root bench.py. Prints one JSON line per
completed class, {"metric", "value", "unit", "vs_baseline", ...}, the last
line being the largest class that ran. vs_baseline is the speedup over the
reference suite's best harnessed backend for the same NPB class (MKL on
its Intel rig); values > 1 mean faster than that.

The run uses df64 (double-word f32) arithmetic so the result is verified
(zeta rel err <= 1e-10). LILAC_BENCH_CLASS forces one class instead of the
ladder A, B, C (class D, through the hierarchical plans, and class E run
only when forced); LILAC_BENCH_DTYPE / LILAC_BENCH_KERNEL override the value
policy and the operator; the ladder stops climbing once LILAC_BENCH_BUDGET_S
seconds have passed. The process exits 1 when a df64 / f64 run fails
verification and raises when no GPU is present.
"""

from __future__ import annotations

import json
import sys
import time

# the reference suite's best harnessed backend per class (MKL, seconds)
BASELINE_S = {
    "S": 0.05,
    "W": 0.08,
    "A": 0.23,
    "B": 19.48,
    "C": 51.82,
    "D": 2181.90,
    # class E was never run by the reference suite; MKL class D scaled by
    # the NPB flop-model ratio E/D (~13.5x)
    "E": 29456.0,
}

LADDER = ("A", "B", "C")


def run_class(class_name: str, dtype: str, kernel: str, device="cuda") -> dict:
    """Run one class and return its result line."""
    import torch

    from lilac_tpu_torch.workloads import npb_cg

    t0 = time.time()
    res = npb_cg.run(class_name, dtype=dtype, kernel=kernel, device=device)
    dev = torch.device(device)
    return {
        "metric": f"npb_cg_class{res.class_name}_time_to_solution",
        "value": round(res.time_s, 4),
        "unit": "s",
        "vs_baseline": round(BASELINE_S[res.class_name] / res.time_s, 2),
        "verified": bool(res.verified),
        "zeta_rel_err": float(f"{res.rel_err:.3e}"),
        "mops": round(res.mops, 1),
        "dtype": res.dtype,
        "kernel": res.kernel,
        "factored_vt": res.factored_vt,
        "nnz": res.nnz,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "class_wall_s": round(time.time() - t0, 1),
    }


def main() -> int:
    import torch

    from lilac_tpu_torch.config import cfg

    if not torch.cuda.is_available():
        raise RuntimeError("bench_npb measures on a GPU and found none")
    conf = cfg()
    t0 = time.time()
    classes = (conf.bench_class,) if conf.bench_class else LADDER
    rc = 0
    for class_name in classes:
        line = run_class(class_name, conf.bench_dtype, conf.bench_kernel)
        if not (line["verified"] or conf.bench_dtype == "f32"):
            line["error"] = "zeta verification FAILED"
            rc = 1
        line["wall_total_s"] = round(time.time() - t0, 1)
        print(json.dumps(line), flush=True)
        if rc or time.time() - t0 > conf.bench_budget_s:
            break
    return rc


if __name__ == "__main__":
    sys.exit(main())
