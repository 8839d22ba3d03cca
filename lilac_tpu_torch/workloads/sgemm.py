"""Parboil sgemm workload: C = A·Bᵀ on column-major text matrices.

Counterpart of lilac_tpu/workloads/sgemm.py. Parboil
(benchmarks/sgemm/src/base/main.cc:40-95) reads A [m, k] and Bᵀ [n, k] as
column-major text (io.cc:17-37), runs one GEMM, writes C column-major and
prints GFLOP/s; the golden comparison uses parboil's float tolerance.

kernel: "cuda" (kernel K12, kernels/gemm.py; what "auto" means) or
"torch" (one torch.matmul with TF32 off, the counterpart of the
reference's XLA option). The reference's names are taken too and mean
what they mean there: "pallas" (its hand kernel, its default) runs K12,
"xla" runs torch.matmul.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class SgemmResult:
    m: int
    n: int
    k: int
    time_s: float
    gflops: float
    kernel: str


def read_col_major(path: str):
    """io.cc:17-37: 'rows cols' then rows*cols floats, column-major. Returns
    the [rows, cols] float32 matrix (a transposed view of the file order)."""
    with open(path) as f:
        toks = f.read().split()
    nr, nc = int(toks[0]), int(toks[1])
    v = np.asarray(toks[2 : 2 + nr * nc], dtype=np.float64).astype(np.float32)
    return v.reshape((nc, nr)).T


def write_col_major(path: str, mat: np.ndarray) -> None:
    nr, nc = mat.shape
    with open(path, "w") as f:
        f.write(f"{nr} {nc} ")
        f.write(" ".join(repr(float(x)) for x in mat.T.ravel()))
        f.write("\n")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# every kernel name run_arrays takes -> the port's route
KERNELS = {"auto": "cuda", "cuda": "cuda", "torch": "torch",
           "pallas": "cuda", "xla": "torch"}


def run_arrays(A: np.ndarray, BT: np.ndarray, kernel: str = "auto", device="cuda"):
    """C = A @ BT.T on `device`. Returns (C as numpy, SgemmResult): one
    warm-up call, then 4 chained repetitions timed up to a synchronised
    scalar read-back. SgemmResult.kernel is the route taken, "cuda" or
    "torch"."""
    from lilac_tpu_torch.kernels import gemm

    if kernel not in KERNELS:
        raise ValueError(f"unknown sgemm kernel {kernel!r}: {' | '.join(KERNELS)}")
    kernel = KERNELS[kernel]
    fn = gemm.matmul_nt if kernel == "cuda" else gemm.matmul_nt_torch
    m, k = A.shape
    n, _ = BT.shape
    dev = torch.device(device)
    a = torch.as_tensor(np.ascontiguousarray(A, dtype=np.float32), device=dev)
    bt = torch.as_tensor(np.ascontiguousarray(BT, dtype=np.float32), device=dev)
    C = fn(a, bt)
    _ = float(C[0, 0])  # warm-up fence (a scalar read-back, not all of C)
    reps = 4
    t0 = time.perf_counter()
    acc = torch.zeros((), dtype=torch.float32, device=dev)
    for _ in range(reps):
        acc = acc + fn(a + acc * 0, bt)[0, 0]  # chained: forces sequential
    _ = float(acc)
    _sync(dev)
    t = time.perf_counter() - t0
    res = SgemmResult(m=m, n=n, k=k, time_s=t / reps,
                      gflops=2.0 * m * n * k * reps / t / 1e9, kernel=kernel)
    return C.cpu().numpy(), res


def run(a_path: str, bt_path: str, out_path: Optional[str] = None,
        golden_path: Optional[str] = None, kernel: str = "auto", device="cuda"):
    """The Parboil protocol on files: (C, SgemmResult, matched or None)."""
    A = read_col_major(a_path)
    BT = read_col_major(bt_path)
    C, res = run_arrays(A, BT, kernel=kernel, device=device)
    matched = None
    if golden_path:
        from lilac_tpu_torch.workloads.parboil_spmv import compare

        ref = read_col_major(golden_path)
        matched = compare(ref.ravel(), C.ravel())
    if out_path:
        write_col_major(out_path, C)
    return C, res, matched
