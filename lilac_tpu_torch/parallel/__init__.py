"""Distribution over ranks of a torch.distributed group (counterpart of
lilac_tpu/parallel/): the mesh and its collectives (mesh.py), the SPMD
runner (launch.py), the row-block plans and solvers (dist.py), the halo
exchange (halo.py) and the per-shard routing networks (dist_routed.py)."""

from lilac_tpu_torch.parallel.dist import (  # noqa: F401
    DistAlg,
    DistSpmvPlan,
    dist_cg_solve,
    dist_npb_power_method,
    make_mesh,
)
