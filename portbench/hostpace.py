"""Read the host's pace through one cell, in one process: set the cell up
once, then run its window again and again from the same x0, and print for
each window the steps a second beside what the host and the card did
meanwhile. It tells whether `mops` moves with the host or with the card,
and whether it moves inside one process or only between processes.

    python3 portbench/hostpace.py --workload <name> --seed <n> --windows 12
        [--seconds 10] [--out chiprun_out/<file>.jsonl]

For each window: steps, seconds, steps a second; the process's CPU
seconds over the window's wall seconds; the share of the machine's CPU
time that its hypervisor gave to others ("steal" in /proc/stat); and the
card's SM clock, power draw and temperature read by nvidia-smi at the
window's end. Needs a CUDA card.
"""

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def cpu_times():
    """(steal, total) jiffies of the machine, from /proc/stat's cpu line."""
    with open("/proc/stat") as f:
        fields = [int(v) for v in f.readline().split()[1:]]
    return fields[7], sum(fields[:8])


def card_state() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60).stdout.strip()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--windows", type=int, default=12)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench import harness, run

    run.pin_environment()
    import torch

    if not torch.cuda.is_available():
        print("hostpace: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    r = harness.Readings(on_card=True)
    t0 = time.perf_counter()
    cell_run = harness.driver(cell.config["kind"]).Run(cell, args.seed, "cuda", r)
    print(f"{args.workload}: set-up {time.perf_counter() - t0:.3f} s", flush=True)
    out = open(args.out, "a") if args.out else None
    try:
        for k in range(args.windows):
            steal0, total0 = cpu_times()
            cpu0 = time.process_time()
            cell_run.window(args.seconds)
            cpu = time.process_time() - cpu0
            steal1, total1 = cpu_times()
            steps = r.counts["window_steps"]
            row = {"workload": args.workload, "window": k, "steps": steps,
                   "seconds": r.window_s, "steps_per_s": steps / r.window_s,
                   "cpu_per_wall": cpu / r.window_s,
                   "steal_share": (steal1 - steal0) / max(total1 - total0, 1),
                   "card": card_state()}
            print(json.dumps(row), flush=True)
            if out:
                out.write(json.dumps(row) + "\n")
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
