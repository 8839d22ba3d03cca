"""NPB CG benchmark workload (flagship end-to-end slice).

Counterpart of lilac_tpu/workloads/npb_cg.py. Reproduces the NAS CG
benchmark semantics exactly (cg.f:53-439): makea matrix, one untimed
warm-up power iteration, then `niter` timed iterations of (25-step CG +
zeta update), verified against the per-class zeta constants to 1e-10
relative (cg.f:363-368). MOp/s uses NPB's closed-form flop count
(cg.f:395-402).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Union

import numpy as np
import torch

from lilac_tpu_torch.generate.npb import CLASSES
from lilac_tpu_torch.generate.npb import make_cg_matrix
from lilac_tpu_torch.kernels.registry import get_kernel
from lilac_tpu_torch.plan import FactoredNPBPlan, SpmvPlan
from lilac_tpu_torch.solvers.algebra import get_algebra
from lilac_tpu_torch.solvers.cg import npb_power_method


@dataclasses.dataclass
class NPBCGResult:
    class_name: str
    zeta: float
    zeta_verify: float
    verified: bool
    rel_err: float
    time_s: float
    mops: float
    niter: int
    nnz: int
    dtype: str
    kernel: str
    rnorm_last: float
    zeta_history: Optional[np.ndarray] = None  # zeta after each outer step
    # how V^T was applied: its own plan, or V's in reverse (None: an
    # assembled matrix, no factored operator)
    factored_vt: Optional[str] = "plan"
    rnorm_history: Optional[np.ndarray] = None  # rnorm after each outer step


def nnz_per_row_flops(cls) -> float:
    """NPB's flop model term (cg.f:398-399): nonzer*(nonzer+1) per row."""
    return float(cls.nonzer * (cls.nonzer + 1))


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(
    class_name: str = "S",
    *,
    dtype: str = "f64",
    kernel: str = "factored",
    niter: Optional[int] = None,
    plan: Optional[Union[FactoredNPBPlan, SpmvPlan]] = None,
    verbose: bool = False,
    steps_per_dispatch: Optional[int] = None,
    device="cuda",
) -> NPBCGResult:
    """Run NPB CG for one class on `device` (ignored when a plan is given:
    the plan's device is used).

    kernel="factored" (the default) stages the factored operator
    (FactoredNPBPlan); any other registry name assembles NPB's matrix
    (make_cg_matrix) into an SpmvPlan with that kernel, as the reference
    does. The reference defaults to "auto" (its SpmvPlan selector); the
    port keeps "factored", the operator its main path measures. A name the
    registry lacks raises the registry's KeyError."""
    cls = CLASSES[class_name.upper()]
    n_it = niter if niter is not None else cls.niter
    if steps_per_dispatch is None:
        from lilac_tpu_torch.config import cfg

        steps_per_dispatch = cfg().steps_per_dispatch
    # outer steps between host read-backs of the histories; default: the
    # whole loop, one read-back at the end
    chunk = n_it if steps_per_dispatch is None else int(steps_per_dispatch)
    chunk = max(1, min(chunk, n_it))

    if plan is None:
        if kernel == "factored":
            plan = FactoredNPBPlan(class_name, dtype=dtype, device=device)
        else:
            if kernel != "auto":
                get_kernel(kernel)
            indptr, indices, data, _ = make_cg_matrix(class_name)
            plan = SpmvPlan(indptr, indices, data, (cls.na, cls.na), dtype=dtype,
                            kernel=kernel, device=device)
    device = plan.device
    alg = get_algebra(dtype, device=device)

    def run_chunk(x, steps):
        return npb_power_method(plan.matvec_with, alg, plan.A, x, cls.shift, steps)

    x0 = plan.vec_in(np.ones(cls.na, dtype=np.float64))

    def full_run(x):
        zs, rs = [], []
        done = 0
        while done < n_it:
            steps = min(chunk, n_it - done)
            zetas, rnorms, x = run_chunk(x, steps)
            # histories stay on the device; a chunk boundary is where the
            # host reads them back
            zs.append(_scalars_to_f64(zetas, dtype))
            rs.append(_scalars_to_f64(rnorms, dtype))
            done += steps
        return np.concatenate(zs), np.concatenate(rs), x

    # untimed warm-up iteration (cg.f:233-272); also builds the kernels
    warm = run_chunk(x0, 1)
    _scalars_to_f64(warm[0], dtype)

    _sync(device)
    t0 = time.perf_counter()
    zeta_hist, rnorm_hist, _ = full_run(x0)
    _sync(device)
    t = time.perf_counter() - t0

    zeta = float(zeta_hist[-1])
    rel_err = abs(zeta - cls.zeta_verify) / cls.zeta_verify
    verified = rel_err <= 1e-10

    term = nnz_per_row_flops(cls)
    mflops = (
        2.0 * n_it * cls.na * (3.0 + term + 25.0 * (5.0 + term) + 3.0) / t / 1e6
    )

    if verbose:
        for i, (zv, rv) in enumerate(zip(zeta_hist, rnorm_hist)):
            print(f"  it {i + 1:4d}  rnorm {rv:.14e}  zeta {zv:.13f}")

    return NPBCGResult(
        class_name=cls.name,
        zeta=zeta,
        zeta_verify=cls.zeta_verify,
        verified=verified,
        rel_err=rel_err,
        time_s=t,
        mops=mflops,
        niter=n_it,
        nnz=plan.nnz,
        dtype=dtype,
        kernel=plan.kernel,
        rnorm_last=float(rnorm_hist[-1]),
        zeta_history=zeta_hist,
        factored_vt=getattr(plan, "factored_vt", None),
        rnorm_history=rnorm_hist,
    )


def _scalars_to_f64(arr, dtype: str) -> np.ndarray:
    from lilac_tpu_torch.ops import dfloat as df

    if dtype == "df64":
        return df.to_f64(arr)
    return arr.detach().cpu().numpy().astype(np.float64)


def print_report(r: NPBCGResult) -> str:
    """The NPB report card (common/print_results.f layout)."""
    card = f"""
 CG Benchmark Completed (lilac_tpu_torch)
 Class           =             {r.class_name:>12s}
 Size            =             {CLASSES[r.class_name].na:>12d}
 Iterations      =             {r.niter:>12d}
 Time in seconds =             {r.time_s:>12.2f}
 Mop/s total     =             {r.mops:>12.2f}
 Operation type  =   floating point ({r.dtype})
 Verification    =             {"SUCCESSFUL" if r.verified else "UNSUCCESSFUL":>12s}
 Zeta            =             {r.zeta:>20.13E}
 Kernel          =             {r.kernel:>12s}
"""
    print(card)
    return card
