"""Run one cell several times on this machine, one process after another,
and print each metric's median and spread: what a bound is set from.

    python3 portbench/sets.py --workload <name> --seeds 11,12,13 [--sets 2]
        [--seconds 20] [--trace 0] [--out chiprun_out/<file>.jsonl]

Each set runs run.py once a seed, in the order given; every set uses the
same seeds. The spread of a metric in a set is the distance between its
first and third quartiles (statistics.quantiles, n=4) as a share of its
median; it is also given with the run farthest from the median left out,
and setup_s again over the set's warm runs alone (those whose result
says "cold": false). Each run's result line goes to --out with the set,
the seed, the exit code and the end of its standard error.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def spread(values):
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2 if q2 else float("nan")


def spread_without_farthest(values):
    """The spread with the value farthest from the median left out."""
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return spread(values[:far] + values[far + 1:])


def summary(label, vals) -> str:
    line = (f"{label}: median {statistics.median(vals)!r} spread {spread(vals)!r}")
    if len(vals) >= 3:
        line += f" without the farthest {spread_without_farthest(vals)!r}"
    return line + f" n {len(vals)}"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--sets", type=int, default=1)
    p.add_argument("--seconds", type=float)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    seconds = args.seconds
    if seconds is None:
        with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
            seconds = json.load(f)["run_seconds"]
    seeds = [int(s) for s in args.seeds.split(",")]
    print(f"card: {card()}", flush=True)
    rows = []
    out = open(args.out, "a") if args.out else None
    try:
        for k in range(args.sets):
            for seed in seeds:
                t0 = time.perf_counter()
                proc = subprocess.run(
                    [sys.executable, os.path.join(HERE, "run.py"), "--workload",
                     args.workload, "--seed", str(seed), "--seconds", str(seconds),
                     "--trace", str(args.trace)],
                    cwd=ROOT, capture_output=True, text=True)
                wall = time.perf_counter() - t0
                try:
                    res = json.loads(proc.stdout.strip().splitlines()[-1])
                except (IndexError, ValueError):
                    res = None
                row = {"workload": args.workload, "set": k, "seed": seed,
                       "rc": proc.returncode, "wall_s": wall, "result": res,
                       "stderr_tail": proc.stderr[-3000:]}
                rows.append(row)
                if out:
                    out.write(json.dumps(row) + "\n")
                    out.flush()
                brief = {m: v["value"] for m, v in (res or {}).get("metrics", {}).items()}
                print(f"set {k} seed {seed} rc {proc.returncode} wall {wall:.1f} "
                      f"cold {res and res.get('cold')} "
                      f"correct {res and res['correct']} attempted "
                      f"{res and res['attempted']} {json.dumps(brief)}", flush=True)
                if res is None:
                    print(proc.stderr[-3000:], flush=True)
    finally:
        if out:
            out.close()
    for k in range(args.sets):
        ok = [r["result"] for r in rows if r["set"] == k and r["result"]]
        names = sorted({m for res in ok for m in res["metrics"]})
        for m in names:
            vals = [res["metrics"][m]["value"] for res in ok if m in res["metrics"]]
            if len(vals) >= 2:
                print(summary(f"set {k} {m}", vals))
        warm = [res["metrics"]["setup_s"]["value"] for res in ok
                if not res.get("cold") and "setup_s" in res["metrics"]]
        if len(warm) >= 2:
            print(summary(f"set {k} setup_s (warm runs)", warm))
    return 0


if __name__ == "__main__":
    sys.exit(main())
