"""dryrun_multichip: one step of every distributed plan family on tiny
shapes, the counterpart of the root __graft_entry__.dryrun_multichip of
the JAX package (which stays that package's entry)."""

from __future__ import annotations

import numpy as np

from lilac_tpu_torch.parallel.launch import run_spmd


def _dryrun_rank(mesh) -> dict:
    from lilac_tpu_torch.generate.stencil import seven_point_csr
    from lilac_tpu_torch.parallel.dist import (
        DistSpmvPlan,
        dist_bicg_solve,
        dist_cg_solve,
        dist_npb_power_method,
        dist_transposed_plan,
    )
    from lilac_tpu_torch.parallel.dist_routed import (
        DistRoutedHierPlan,
        DistRoutedPlan,
        HaloRoutedPlan,
    )
    from lilac_tpu_torch.parallel.halo import HaloSpmvPlan, halo_matvec

    # a tiny 7-point stencil system, row-sharded over every rank
    indptr, indices, data, shape = seven_point_csr(8, 8, 4)
    ones = np.ones(shape[0])
    out = {"transport": mesh.transport, "size": mesh.size, "device": str(mesh.device)}
    plan = DistSpmvPlan.build(indptr, indices, data, shape, mesh, dtype="f32")
    x0 = plan.vec_in(ones)
    zetas, _, _ = dist_npb_power_method(plan, x0, shift=5.0, niter=2)
    out["zetas"] = zetas
    out["cg"] = plan.vec_out(dist_cg_solve(plan, x0, maxit=5, rtol=1e-8)[0])
    hplan = HaloSpmvPlan.build(indptr, indices, data, shape, mesh, dtype="f32")
    out["halo"] = hplan.vec_out(halo_matvec(hplan, hplan.vec_in(ones)))
    for name, cls, kw in (("routed", DistRoutedPlan, {}), ("halo_routed", HaloRoutedPlan, {}),
                          ("routed_hier", DistRoutedHierPlan, {"bl": 128})):
        p = cls.build(indptr, indices, data, shape, mesh, dtype="f32", **kw)
        out[name] = p.vec_out(dist_cg_solve(p, p.vec_in(ones), maxit=5)[0])
    tplan = dist_transposed_plan(indptr, indices, data, shape, mesh, dtype="f32")
    x, its, _, _ = dist_bicg_solve(plan, tplan, plan.vec_in(ones), maxit=5)
    out["bicg"] = plan.vec_out(x)
    out["bicg_its"] = its
    return out


def dryrun_multichip(n_devices: int, device="cuda", *, backend: str | None = None) -> list:
    """Run one step of every plan family (DistSpmvPlan with the power method,
    CG and BiCG on its staged transpose; HaloSpmvPlan; DistRoutedPlan,
    HaloRoutedPlan and DistRoutedHierPlan with CG) on `n_devices` ranks.
    backend: "nccl" (one rank per card) or "gloo" (the host transport);
    None is NCCL on CUDA and Gloo on the CPU. Returns each rank's results:
    every vector gathered whole, the transport named."""
    if backend is None:
        backend = "gloo" if str(device) == "cpu" else "nccl"
    return run_spmd(_dryrun_rank, n_devices, backend=backend, device=device)
