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
policy and the operator; LILAC_BENCH_BUDGET_S is the run's budget. The
process exits 1 when a df64 / f64 run fails verification and raises when no
GPU is present.

The ladder keeps to its budget as the reference's bench.py does: each
completed rung is printed (banked) before the next one starts; the next
rung starts only if the remaining budget covers 1.25 times its predicted
wall plus 15 s, the prediction being its warm wall on the card
(WARM_WALL_S) scaled by how much slower than its own warm wall this run's
last rung was; and a watchdog thread prints the best line so far and ends
the process when the budget is spent, even while the main thread waits in
a native call. A fingerprint of the card (HBM copy GB/s, launch round trip,
and with quick=False K1's stage rate) goes to stderr and on every result
line, so runs on different hosts can be compared.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
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

# warm wall of each rung (class_wall_s: plan build and timed run, the CUDA
# kernels already built), measured on an NVIDIA H100 80GB HBM3 at a 700.00 W
# power limit by `python -m lilac_tpu_torch.bench_npb` (PERF.md section 6)
WARM_WALL_S = {"A": 4.7, "B": 25.1, "C": 30.5}


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


def fingerprint(quick: bool = True, device="cuda") -> dict:
    """Probes of the card this run holds: HBM copy GB/s (an in-place add over
    256 MB of f32, read and written, 30 times between two
    synchronisations), the round trip of one tiny launch and its read-back
    in ms, and with quick=False K1's stage rate (measure_stage_roofline at
    m = 2^17, S = 48) in Gstage-elements/s. Printed on stderr."""
    import torch

    dev = torch.device(device)
    fp = {}
    nbig = 1 << 26  # 256 MB of f32
    v = torch.zeros(nbig, dtype=torch.float32, device=dev)
    reps = 30
    v.add_(1.0)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        v.add_(1.0)
    torch.cuda.synchronize(dev)
    dt = (time.perf_counter() - t0) / reps
    fp["hbm_copy_gbps"] = round(2 * nbig * 4 / dt / 1e9, 1)
    del v
    tiny = torch.zeros(8, dtype=torch.float32, device=dev)
    float((tiny + 1.0)[0])
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        tiny = tiny + 1.0
        float(tiny[0])  # the round trip of each launch
    fp["dispatch_ms"] = round((time.perf_counter() - t0) / reps * 1e3, 3)
    if not quick:
        from lilac_tpu_torch.utils.profiling import measure_stage_roofline

        p = measure_stage_roofline(m=1 << 17, S=48, device=dev)
        fp["stage_gelems_s"] = round(p["stage_elems_per_s"] / 1e9, 2)
    print(f"bench: fingerprint {fp}", file=sys.stderr, flush=True)
    return fp


def next_rung_fits(rung: str, wall: float, nxt: str, remaining: float,
                   first: bool) -> tuple:
    """(fits, predicted wall of `nxt`): its warm wall scaled by this run's
    slowness on `rung` (at least 1; a first rung counts at most twice its
    warm wall, which leaves out the one-time kernel builds), and whether
    `remaining` seconds cover 1.25 times that plus 15 s."""
    warm = WARM_WALL_S[rung]
    slow = max(1.0, (min(wall, warm * 2.0) if first else wall) / warm)
    pred = WARM_WALL_S[nxt] * slow
    return remaining >= 1.25 * pred + 15.0, pred


class _Ladder:
    """The best banked line and the one exit path that prints it: the main
    thread at the ladder's end, or the watchdog at the budget."""

    def __init__(self, t0: float):
        self.t0 = t0
        self.best = None
        self.phase = "startup"
        self.lock = threading.Lock()

    def bank(self, line: dict) -> None:
        with self.lock:
            line["wall_total_s"] = round(time.time() - self.t0, 1)
            self.best = line
            print(json.dumps(line), flush=True)

    def emit_and_exit(self) -> None:
        """Print the best line so far (or an incomplete one) last and end
        the process at once, whatever the main thread is doing."""
        with self.lock:
            best = self.best or {
                "metric": "npb_cg_bench_incomplete", "value": 0.0, "unit": "s",
                "vs_baseline": 0.0,
                "error": f"no class completed within budget (stuck in: {self.phase})"}
            best["wall_total_s"] = round(time.time() - self.t0, 1)
            print(json.dumps(best), flush=True)
            sys.stderr.flush()
            ok = best.get("verified") or (best.get("dtype") == "f32" and "error" not in best)
            os._exit(0 if ok else 1)

    def watchdog(self, deadline: float) -> None:
        while True:
            left = deadline - time.time()
            if left <= 0:
                print("bench: budget watchdog fired, emitting best-so-far",
                      file=sys.stderr, flush=True)
                self.emit_and_exit()
            time.sleep(min(left, 2.0))


def main() -> int:
    import torch

    from lilac_tpu_torch.config import cfg

    if not torch.cuda.is_available():
        raise RuntimeError("bench_npb measures on a GPU and found none")
    conf = cfg()
    budget = conf.bench_budget_s
    ladder = _Ladder(time.time())
    signal.signal(signal.SIGTERM, lambda s, f: ladder.emit_and_exit())
    threading.Thread(target=ladder.watchdog,
                     args=(ladder.t0 + max(30.0, budget - 10.0),), daemon=True).start()
    ladder.phase = "fingerprint"
    fp = fingerprint(quick=True)
    classes = (conf.bench_class,) if conf.bench_class else LADDER
    for i, class_name in enumerate(classes):
        ladder.phase = f"class {class_name}"
        line = run_class(class_name, conf.bench_dtype, conf.bench_kernel)
        line["fingerprint"] = fp
        if not (line["verified"] or conf.bench_dtype == "f32"):
            line["error"] = "zeta verification FAILED"
            ladder.bank(line)
            return 1
        ladder.bank(line)
        if i + 1 == len(classes):
            break
        nxt = classes[i + 1]
        remaining = budget - (time.time() - ladder.t0)
        fits, pred = next_rung_fits(class_name, line["class_wall_s"], nxt,
                                    remaining, first=i == 0)
        if not fits:
            print(f"bench: stopping ladder at {class_name} (next={nxt} pred "
                  f"{pred:.0f}s, remaining {remaining:.0f}s)", file=sys.stderr)
            break
    return 0


if __name__ == "__main__":
    sys.exit(main())
