"""Helpers of the benchmark's tests: a checkout of the benchmark with a
class S cell added as files, and a run of it on the CPU in a process of
its own (no card here, so the look for one is skipped)."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)

CLASS_S = {
    "kind": "npb_cg", "source": "NPB 3.4 CG class S", "class": "S", "na": 1400,
    "nonzer": 7, "niter": 15, "shift": 10.0, "rcond": 0.1,
    "zeta_verify": 8.5971775078648,
}


def limits(cell: str) -> dict:
    with open(os.path.join(BENCH, "workloads", cell + ".json")) as f:
        return json.load(f)["limits"]


def make_checkout(root, dtype: str = "df64", limits_of: str = "npb-cg-C.df64") -> str:
    """root/BENCHMARK.json and root/portbench/ (the benchmark's files
    copied), plus the files of one new cell `npb-cg-S.<dtype>`: a
    configuration, a traffic mix of one step a chunk and the cell's file,
    judged by the limits of the cell `limits_of`."""
    root = str(root)
    dst = os.path.join(root, "portbench")
    shutil.copytree(BENCH, dst, ignore=shutil.ignore_patterns("cache", "__pycache__"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = f"npb-cg-S.{dtype}"
    traffic = f"{dtype}.chunk1"
    _write(os.path.join(dst, "configs", "npb-cg-S.json"), CLASS_S)
    _write(os.path.join(dst, "traffic", traffic + ".json"),
           {"dtype": dtype, "steps_per_chunk": 1})
    _write(os.path.join(dst, "workloads", cell + ".json"),
           {"profile_steps": 1, "profile_products": 2, "limits": limits(limits_of)})
    bench["configs"].append({"name": "npb-cg-S", "source": "NPB 3.4 CG class S",
                             "file": "portbench/configs/npb-cg-S.json", "reduced": [],
                             "why": "tests"})
    bench["workloads"].append({"name": cell, "config": "npb-cg-S", "traffic": traffic,
                               "chips": 1, "why": "tests"})
    _write(os.path.join(root, "BENCHMARK.json"), bench)
    return root


def _write(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def run_cpu(root, workload: str, seed: int = 1, seconds: float = 0.5, trace: int = 0,
            patch: str = "", timeout: float = 600):
    """Run one cell of the checkout at `root` on the CPU through run.execute
    in a new process, after the code `patch` (a fault planted in the
    program). Returns the CompletedProcess."""
    script = "\n".join([
        "import os, sys",
        f"sys.path[:0] = [{str(root)!r}, {REPO!r}]",
        "from portbench import run",
        "run.pin_environment()",
        # the card's default layout, routed, is what the reference numbers
        # vectors by; on the CPU it runs through the kernels' plain versions
        "os.environ['LILAC_FACTORED_SEGMODE'] = 'routed'",
        "import torch",
        "torch.set_num_threads(2)",
        patch,
        f"sys.exit(run.execute({workload!r}, {seed}, {seconds}, {bool(trace)}, device='cpu'))",
    ])
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, "-c", script], cwd=str(root), env=env,
                          capture_output=True, text=True, timeout=timeout)


def result(proc) -> dict:
    """The result object on the run's last line of standard output."""
    return json.loads(proc.stdout.strip().splitlines()[-1])
