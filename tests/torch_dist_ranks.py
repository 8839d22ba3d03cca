"""Rank functions of the distributed tests (tests/test_torch_dist.py,
tests/test_torch_dist_routed.py).

They run in ranks that lilac_tpu_torch.parallel.launch.run_spmd spawns,
and each rank imports this module afresh: it imports no JAX. A case is a
dict of numpy inputs built by the test; `run_cases` runs every case on
every rank and returns what the test compares with the JAX package:
whole vectors (vec_out gathers them on every rank) and the replicated
histories."""

import numpy as np
import torch

from lilac_tpu_torch import convert_reference as cr
from lilac_tpu_torch.parallel import dist as D
from lilac_tpu_torch.parallel import dist_routed as DR
from lilac_tpu_torch.parallel import halo as H

BUILDERS = {"dist": D.DistSpmvPlan.build, "halo": H.HaloSpmvPlan.build,
            "routed": DR.DistRoutedPlan.build, "hier": DR.DistRoutedHierPlan.build,
            "halo_routed": DR.HaloRoutedPlan.build}
FROM_ARRAYS = {"dist": cr.dist_spmv_plan_from_arrays, "halo": cr.halo_plan_from_arrays,
               "routed": cr.dist_routed_plan_from_arrays,
               "hier": cr.dist_routed_hier_plan_from_arrays}


def _plan(mesh, case):
    """The port's plan of a case: built from the CSR, or from the JAX plan's
    arrays (case["arrays"])."""
    if "arrays" in case:
        return FROM_ARRAYS[case["plan"]](**case["arrays"], mesh=mesh)
    ip, ix, dv, shape = case["csr"]
    return BUILDERS[case["plan"]](ip, ix, dv, shape, mesh, dtype=case["dtype"],
                                  **case.get("kw", {}))


def _run(mesh, case):
    plan = _plan(mesh, case)
    op = case["op"]
    if op == "matvec":
        return plan.vec_out(plan.local_matvec(plan.a_arrays, plan.vec_in(case["x"])))
    if op == "power":
        z, r, x = D.dist_npb_power_method(plan, plan.vec_in(np.ones(plan.shape[0])),
                                          case["shift"], case["niter"])
        return {"zetas": z, "rnorms": r, "x": plan.vec_out(x)}
    if op == "cg":
        x, it, rn = D.dist_cg_solve(plan, plan.vec_in(case["b"]), maxit=case["maxit"],
                                    rtol=case["rtol"])
        return {"x": plan.vec_out(x), "it": it, "rnorm": rn}
    if op == "bicg":
        ip, ix, dv, shape = case["csr"]
        plan_t = D.dist_transposed_plan(ip, ix, dv, shape, mesh, dtype=case["dtype"])
        x, its, hist, rn = D.dist_bicg_solve(plan, plan_t, plan.vec_in(case["b"]),
                                             maxit=case["maxit"], rtol=case["rtol"])
        return {"x": plan.vec_out(x), "its": its, "hist": hist, "rnorm": rn}
    raise ValueError(f"unknown op {op!r}")


def run_cases(mesh, cases: dict) -> dict:
    out = {name: _run(mesh, case) for name, case in cases.items()}
    out["_mesh"] = {"rank": mesh.rank, "size": mesh.size, "transport": mesh.transport}
    return out


def fail_on_rank(mesh, bad: int):
    """Rank `bad` raises; every other rank waits for it in a collective."""
    if mesh.rank == bad:
        raise RuntimeError(f"rank {bad} gives up")
    return mesh.all_gather_tiled(torch.ones(1))
