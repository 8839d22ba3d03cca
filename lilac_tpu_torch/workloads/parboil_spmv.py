"""Parboil spmv benchmark workload.

Counterpart of lilac_tpu/workloads/parboil_spmv.py. Parboil's semantics
(benchmarks/spmv/src/cpu/main.c:80-117): load a MatrixMarket matrix
(symmetric entries mirrored, convert_dataset.c:82-112), read the f32 input
vector (file.c:57-62), run 50 repetitions of the FLOAT SpMV, and compare
the result with the golden output by parboil's tolerance: abs diff <=
1e-4·max|ref| OR rel < 0.2% (tools/compare-output:13-35). Golden files
hold a uint32 length and the f32 payload (file.c:64-78).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

REPS = 50  # main.c:93


@dataclasses.dataclass
class ParboilResult:
    rows: int
    nnz: int
    reps: int
    time_s: float
    gflops: float
    matched: Optional[bool]  # None when no golden file
    max_abs_err: Optional[float]
    kernel: str = ""  # the registry kernel the plan ran
    plan: object = dataclasses.field(default=None, repr=False)  # the SpmvPlan


def read_vector_bin(path: str, n: int) -> np.ndarray:
    v = np.fromfile(path, dtype="<f4", count=n)
    if len(v) < n:
        raise ValueError(f"{path}: wanted {n} floats, got {len(v)}")
    return v


def read_golden(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        n = int(np.fromfile(f, dtype="<u4", count=1)[0])
        return np.fromfile(f, dtype="<f4", count=n)


def write_output(path: str, y: np.ndarray) -> None:
    with open(path, "wb") as f:
        np.asarray([len(y)], dtype="<u4").tofile(f)
        y.astype("<f4").tofile(f)


def compare(ref: np.ndarray, got: np.ndarray) -> bool:
    """parboil compare-output semantics."""
    if len(ref) != len(got):
        return False
    abstol = 1e-4 * np.abs(ref).max()
    diff = np.abs(ref.astype(np.float64) - got.astype(np.float64))
    ok = (diff <= abstol) | (diff < 0.002 * np.abs(ref))
    return bool(ok.all())


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(
    mtx_path: str,
    vec_path: str,
    *,
    golden_path: Optional[str] = None,
    out_path: Optional[str] = None,
    reps: int = REPS,
    kernel: str = "auto",
    device="cuda",
) -> ParboilResult:
    """Read, plan in f32, run `reps` products on `device` (timed: the second
    run of the chain, up to the synchronised read-back of y) and compare
    with the golden output where one is given. The result keeps the plan."""
    from lilac_tpu_torch.io.readers import read_matrix_market
    from lilac_tpu_torch.plan import SpmvPlan

    indptr, indices, data, shape = read_matrix_market(mtx_path)
    n = shape[0]
    x = read_vector_bin(vec_path, n)
    plan = SpmvPlan(indptr, indices, data, shape, dtype="f32", kernel=kernel,
                    device=device)
    dev = plan.device
    xd = plan.vec_in(x)

    def run_reps():
        # the reference recomputes the same product `reps` times into one
        # output buffer (main.c:93-95); chained through x + 0·y, so the
        # device really runs every repetition
        y = xd
        for _ in range(reps):
            y = plan.matvec_with(plan.A, xd + 0.0 * y)
        return y

    run_reps()
    _sync(dev)  # warm-up fence
    t0 = time.perf_counter()
    y = run_reps()
    _sync(dev)
    y_host = y.detach().cpu().numpy().astype(np.float32)[:n]
    t = time.perf_counter() - t0

    gflops = 2.0 * plan.nnz * reps / t / 1e9
    matched = maxerr = None
    if golden_path and os.path.exists(golden_path):
        ref = read_golden(golden_path)
        matched = compare(ref, y_host)
        maxerr = float(np.abs(ref - y_host).max())
    if out_path:
        write_output(out_path, y_host)
    return ParboilResult(
        rows=n, nnz=plan.nnz, reps=reps, time_s=t, gflops=gflops,
        matched=matched, max_abs_err=maxerr, kernel=plan.kernel, plan=plan,
    )


DATASETS = {
    "small": ("1138_bus.mtx", "1138_bus.mtx.out"),
    "medium": ("bcsstk18.mtx", "bcsstk18.mtx.out"),
    "large": ("Dubcova3.mtx.bin", "Dubcova3.mtx.out"),
}


def run_dataset(name: str, root: str, **kw) -> ParboilResult:
    """One of Parboil's datasets under `root` (the suite's checkout)."""
    mtx, out = DATASETS[name]
    base = os.path.join(root, "datasets", "spmv", name)
    return run(
        os.path.join(base, "input", mtx),
        os.path.join(base, "input", "vector.bin"),
        golden_path=os.path.join(base, "output", out),
        **kw,
    )
