"""Read the numbers a cell's comparison judges, for the program over many
seeds and for the control, in one process each: what a cell's limits are
set from.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,...
        [--control-seeds 101,102,103] [--control-steps N]
        [--seconds 20]
        [--out chiprun_out/<file>.json]

The program is set up once; each seed then makes a new x0 and runs a
window of the cell's length, judged as run.py judges it. The control is
the program's own path one precision below the configuration's
(FactoredNPBPlan with dtype f32), set up once and run the same way: it has
to come out not correct. Prints, and writes to --out, every seed's
numbers, the largest of the program's (the lower readings) and the
smallest of the control's (the upper readings). Needs a CUDA card.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the control's precision: the one below the configurations' f64
CONTROL_DTYPE = "f32"


def readings(cell, seeds, seconds, dtype=None, steps=0):
    from portbench import harness

    drv = harness.driver(cell.config["kind"])
    r = harness.Readings(on_card=True)
    t0 = time.perf_counter()
    run = drv.Run(cell, seeds[0], "cuda", r, dtype=dtype)
    rows = []
    print(f"set-up {time.perf_counter() - t0:.1f} s", flush=True)
    for seed in seeds:
        run.restart(seed)
        run.window(seconds, steps)
        t0 = time.perf_counter()
        v = run.check(free=False)
        rows.append({"seed": seed, "attempted": v.attempted, "failed": v.failed,
                     "correct": v.correct, "window_s": r.window_s,
                     "reference_s": time.perf_counter() - t0,
                     "checks": {c.name: c.value for c in v.checks}})
        print(json.dumps(rows[-1]), flush=True)
    del run
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--control-steps", type=int, default=0,
                   help="run the control this many steps (the steps a run of the "
                        "cell compares) instead of the window's seconds")
    p.add_argument("--seconds", type=float)
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench import harness, run

    run.pin_environment()
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    seconds = args.seconds
    if seconds is None:
        with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
            seconds = json.load(f)["run_seconds"]
    out = {"workload": args.workload, "card": torch.cuda.get_device_name(),
           "seconds": seconds, "limits": cell.workload["limits"]}
    if args.seeds:
        out["program"] = readings(cell, [int(s) for s in args.seeds.split(",")], seconds)
        out["lower"] = {k: max(r["checks"][k] for r in out["program"])
                        for k in out["program"][0]["checks"]}
    if args.control_seeds:
        import gc

        gc.collect()
        torch.cuda.empty_cache()
        seeds = [int(s) for s in args.control_seeds.split(",")]
        out["control"] = readings(cell, seeds, 0.0 if args.control_steps else seconds,
                                  dtype=CONTROL_DTYPE, steps=args.control_steps)
        # a control that gives no number (NaN) has failed and sets no upper end
        out["upper"] = {k: min((r["checks"][k] for r in out["control"]
                                if r["checks"][k] == r["checks"][k]), default=None)
                        for k in out["control"][0]["checks"]}
    print(json.dumps({k: out[k] for k in ("lower", "upper") if k in out}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
