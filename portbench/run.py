"""Run one cell of BENCHMARK.json once on this machine's GPU and print its
result as the last line of standard output.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Needs CUDA and as many cards as the cell asks for: without them it exits
2 and prints no result. With --trace 0 the line holds the cell's
end-to-end metrics, with --trace 1 its per-layer metrics, the device's busy
seconds and a breakdown. Every number the comparison with the reference
judged is printed beside its limit as the last lines of standard error and
under "checks", the result's last key. The key "cold" before it is true
where set-up built a kernel library or a plan file: a checkout's first run
of the cell, whose setup_s is not a warm one.

The run pins the measured program's knobs to their defaults and keeps its
caches inside the checkout, under portbench/cache/.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, "cache")
# top-level module names no process of the benchmark may load
FORBIDDEN = ("jax", "jaxlib", "flax", "lilac_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is a forbidden one, compared
    whole (lilac_tpu_torch is not lilac_tpu)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def pin_environment() -> None:
    """Program knobs at their defaults; caches at fixed paths in the
    checkout, so only a checkout's first run of a cell builds them; one
    thread for the host's numerical libraries (the timed path drives the
    card from one thread; idle pools only compete with it for cores)."""
    for key in [k for k in os.environ if k.startswith("LILAC_")]:
        del os.environ[key]
    for key in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[key] = "1"
    os.environ["LILAC_DATA_DIR"] = os.path.join(CACHE, "lilac_data")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["USE_FLAX"] = "0"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _finite(v):
    """The value for the result line: JSON has no NaN or infinity."""
    if isinstance(v, dict):
        return {k: _finite(u) for k, u in v.items()}
    if isinstance(v, list):
        return [_finite(u) for u in v]
    if isinstance(v, float) and not math.isfinite(v):
        return repr(v)
    return v


def execute(workload: str, seed: int, seconds: float, trace: bool,
            device: str = "cuda") -> int:
    """Run the cell on `device` and print its result. main() calls it once
    it has found the cards; tests call it on the CPU."""
    from portbench import harness

    cell = harness.load_cell(workload)
    out = harness.run_cell(cell, seed, seconds, trace, device=device, t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    out = _finite(out)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


def main(argv=None) -> int:
    args = parse(argv)
    pin_environment()
    if sys.path[0] == HERE:
        sys.path[0] = ROOT
    elif ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from portbench import harness

    chips = harness.load_cell(args.workload).chips
    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s), found {found}",
              file=sys.stderr)
        return 2
    return execute(args.workload, args.seed, args.seconds, bool(args.trace))


if __name__ == "__main__":
    sys.exit(main())
