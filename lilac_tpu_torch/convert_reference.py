"""The JAX package's containers, handed over as numpy arrays and Python
tuples, rebuilt as the port's containers.

With these both packages compute on the same plan: a test (or a migration
script) calls ``np.asarray`` on each field of the JAX container and passes
the arrays here. This module imports neither package's JAX side.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lilac_tpu_torch.formats.sparse import BSR, COO, CSR, ELL, BucketELL, SegBucketELL
from lilac_tpu_torch.kernels.factored import FactoredNPB
from lilac_tpu_torch.kernels.routed_spmv import (
    HierNet,
    RoutedMat,
    RoutedMatHier,
    RoutedMatHierP,
    pack_hier,
)
from lilac_tpu_torch.ops.dfloat import DF
from lilac_tpu_torch.parallel.dist import DistSpmvPlan
from lilac_tpu_torch.parallel.dist_routed import DistRoutedHierPlan, DistRoutedPlan
from lilac_tpu_torch.parallel.halo import HaloSpmvPlan
from lilac_tpu_torch.solvers.line_ilu import LineILU
from lilac_tpu_torch.solvers.precond import ILU0
from lilac_tpu_torch.solvers.tri import LevelSweep
from lilac_tpu_torch.workloads.pathsample import MinDatabase


def _t(a, device, dtype=None):
    # np.array copies: arrays handed over from JAX are read-only views
    return torch.as_tensor(np.array(a, order="C"), dtype=dtype, device=device)


def df_from_arrays(hi, lo, device="cuda") -> DF:
    return DF(_t(hi, device, torch.float32), _t(lo, device, torch.float32))


def routed_mat_from_arrays(
    masks, vals, kinds, dists, chunks, inv_perm, shape, m, colmajor,
    device="cuda",
) -> RoutedMat:
    """masks [B, P, R, 128] int8, vals [B, m] (or [B, m, 2]), inv_perm [n]
    or None; kinds / dists / chunks as the reference's static tuples."""
    return RoutedMat(
        masks=_t(masks, device, torch.int8),
        vals=_t(vals, device),
        kinds=tuple(str(k) for k in kinds),
        dists=tuple(int(d) for d in dists),
        chunks=tuple((int(r), int(k)) for r, k in chunks),
        inv_perm=None if inv_perm is None else _t(inv_perm, device, torch.int64),
        shape=tuple(int(v) for v in shape),
        m=int(m),
        colmajor=bool(colmajor),
    )


def _detuple(x):
    if isinstance(x, (list, tuple)):
        return tuple(_detuple(v) for v in x)
    return x.item() if isinstance(x, np.generic) else x


def hier_mat_from_arrays(
    nets_masks, nets_meta, vals, unperm_masks, unperm_meta, chunks, shape,
    m, m_out, bl, n_nz, colmajor, device="cuda",
) -> RoutedMatHierP:
    """A hierarchical plan from its per-net arrays, packed on `device`
    (pack_hier).

    nets_masks[i][j]: net i's pass j mask array (int8, the plan file's
    layout); nets_meta[i]: its static pass descriptors; vals[i]: [m] or
    [m, 2]; unperm_masks / unperm_meta: the un-permute network or None;
    chunks[i] = ((slot0, rows_c, K), ...)."""
    def host(a):
        return np.array(a, order="C")

    def net(masks, meta):
        return HierNet(pass_masks=tuple(host(mk) for mk in masks),
                       pass_meta=_detuple(meta))

    M = RoutedMatHier(
        nets=tuple(net(mk, meta) for mk, meta in zip(nets_masks, nets_meta)),
        vals=tuple(host(v) for v in vals),
        unperm=None if unperm_meta is None else net(unperm_masks, unperm_meta),
        chunks=_detuple(chunks), shape=tuple(int(v) for v in shape), m=int(m),
        m_out=int(m_out), bl=int(bl), n_nz=int(n_nz), colmajor=bool(colmajor),
    )
    return pack_hier(M, device)


def seg_bucket_ell_from_arrays(
    data, indices, inv_perm, shape, parts, seg_size, identity_perm,
    device="cuda",
) -> SegBucketELL:
    """data / indices: per-part arrays, aligned with parts."""
    return SegBucketELL(
        data=tuple(_t(v, device) for v in data),
        indices=tuple(_t(i, device, torch.int64) for i in indices),
        inv_perm=_t(inv_perm, device, torch.int64),
        shape=tuple(int(v) for v in shape),
        parts=tuple(tuple(int(v) for v in p) for p in parts),
        seg_size=int(seg_size),
        identity_perm=bool(identity_perm),
    )


def csr_from_arrays(data, indices, indptr, shape, row_ids=None,
                    device="cuda") -> CSR:
    return CSR(
        data=_t(data, device), indices=_t(indices, device, torch.int64),
        indptr=_t(indptr, device, torch.int64), shape=tuple(int(v) for v in shape),
        row_ids=None if row_ids is None else _t(row_ids, device, torch.int64),
    )


def coo_from_arrays(row, col, data, shape, device="cuda") -> COO:
    return COO(row=_t(row, device, torch.int64), col=_t(col, device, torch.int64),
               data=_t(data, device), shape=tuple(int(v) for v in shape))


def ell_from_arrays(data, indices, shape, device="cuda") -> ELL:
    return ELL(data=_t(data, device), indices=_t(indices, device, torch.int64),
               shape=tuple(int(v) for v in shape))


def bsr_from_arrays(data, indices, indptr, shape, block_shape, device="cuda") -> BSR:
    return BSR(data=_t(data, device), indices=_t(indices, device, torch.int64),
               indptr=_t(indptr, device, torch.int64),
               shape=tuple(int(v) for v in shape),
               block_shape=tuple(int(v) for v in block_shape))


def bucket_ell_from_arrays(data, indices, inv_perm, shape, widths,
                           device="cuda") -> BucketELL:
    """data / indices: per-bucket arrays, aligned with widths."""
    return BucketELL(
        data=tuple(_t(v, device) for v in data),
        indices=tuple(_t(i, device, torch.int64) for i in indices),
        inv_perm=_t(inv_perm, device, torch.int64),
        shape=tuple(int(v) for v in shape),
        widths=tuple(int(w) for w in widths),
    )


def factored_from_arrays(V, VT, s, d0, device="cuda") -> FactoredNPB:
    """V, VT: containers already converted by the functions above."""
    return FactoredNPB(V=V, VT=VT, s=_t(s, device), d0=_t(d0, device))


def level_sweep_from_arrays(n, rows, cols, vals, device="cuda") -> LevelSweep:
    """A triangular level schedule (solvers/tri.py) from the JAX package's
    LevelSweep fields; its int32 indices become int64."""
    return LevelSweep(n=int(n), rows=_t(rows, device, torch.int64),
                      cols=_t(cols, device, torch.int64),
                      vals=_t(vals, device, torch.float64))


LINE_ILU_PLANES = ("dinv", "am1", "ap1", "am2", "ap2", "am3", "ap3")
LINE_ILU_SCHEDULE = ("lines", "prev2", "prev3", "next2", "next3")


def line_ilu_from_arrays(n1, n2, n3, device="cuda", **fields) -> LineILU:
    """A line-ILU preconditioner (solvers/line_ilu.py) from the JAX
    package's LineILU fields, passed by name: the coefficient planes
    LINE_ILU_PLANES and the wavefront schedule LINE_ILU_SCHEDULE."""
    planes = {k: _t(fields[k], device, torch.float64) for k in LINE_ILU_PLANES}
    sched = {k: _t(fields[k], device, torch.int64) for k in LINE_ILU_SCHEDULE}
    return LineILU(n1=int(n1), n2=int(n2), n3=int(n3), **planes, **sched)


def ilu0_from_arrays(data, indices, row_ids, diag, lower_level, upper_level,
                     lower_level_t, upper_level_t, shape, device="cuda") -> ILU0:
    """An ILU(0) preconditioner (solvers/precond.py) from the JAX package's
    ILU0 fields; the level counts follow from the level arrays."""
    lv = {k: np.asarray(a, dtype=np.int64) for k, a in (
        ("lower_level", lower_level), ("upper_level", upper_level),
        ("lower_level_t", lower_level_t), ("upper_level_t", upper_level_t))}
    return ILU0(
        data=_t(data, device, torch.float64),
        indices=_t(indices, device, torch.int64),
        row_ids=_t(row_ids, device, torch.int64),
        diag=_t(diag, device, torch.float64),
        **{k: _t(a, device) for k, a in lv.items()},
        n_lower_levels=int(lv["lower_level"].max()) + 1,
        n_upper_levels=int(lv["upper_level"].max()) + 1,
        n_lower_levels_t=int(lv["lower_level_t"].max()) + 1,
        n_upper_levels_t=int(lv["upper_level_t"].max()) + 1,
        shape=tuple(int(s) for s in shape),
    )


def min_database_from_arrays(**fields) -> MinDatabase:
    """A PATHSAMPLE database (workloads/pathsample.py) from the JAX
    package's MinDatabase fields, passed by name; the arrays are copied, so
    the two packages' databases share no buffer."""
    names = [f.name for f in dataclasses.fields(MinDatabase)]
    if sorted(fields) != sorted(names):
        raise ValueError(f"MinDatabase fields {sorted(fields)} != {sorted(names)}")
    return MinDatabase(**{k: np.array(fields[k]) for k in names})


# ---- the distributed plans (parallel/): the JAX plan's global arrays,
# [ndev, ...] on the mesh axis, and one rank's mesh -> that rank's plan


def dist_spmv_plan_from_arrays(data, indices, shape, n_pad, dtype, mesh) -> DistSpmvPlan:
    """data [ndev, rps, K] (or [..., 2] for df64), indices [ndev, rps, K]."""
    r, dev = mesh.rank, mesh.device
    return DistSpmvPlan(mesh=mesh, data=_t(data[r], dev),
                        indices=_t(indices[r], dev, torch.int64),
                        shape=tuple(int(v) for v in shape), n_pad=int(n_pad),
                        rps=int(np.shape(data)[1]), dtype=str(dtype))


def halo_plan_from_arrays(data, indices, send_tbls, dist_ks, halos, shape, n_pad,
                          rps, dtype, mesh) -> HaloSpmvPlan:
    """data / indices [ndev, rps, K]; send_tbls: per kept distance [ndev, H_k]."""
    r, dev = mesh.rank, mesh.device
    return HaloSpmvPlan(
        mesh=mesh, data=_t(data[r], dev), indices=_t(indices[r], dev, torch.int64),
        send_tbls=tuple(_t(t[r], dev, torch.int64) for t in send_tbls),
        dist_ks=_detuple(tuple(dist_ks)), halos=_detuple(tuple(halos)),
        shape=tuple(int(v) for v in shape), n_pad=int(n_pad), rps=int(rps),
        dtype=str(dtype))


def _inv(inv_perm, r, dev):
    return None if inv_perm is None else _t(inv_perm[r], dev, torch.int64)


def dist_routed_plan_from_arrays(masks, vals, inv_perm, kinds, dists, chunks, shape,
                                 n_pad, m, rps, dtype, mesh) -> DistRoutedPlan:
    """masks [ndev, B, P, R, 128] int8, vals [ndev, B, m(, 2)], inv_perm
    [ndev, rps] or None."""
    r, dev = mesh.rank, mesh.device
    return DistRoutedPlan(
        mesh=mesh, masks=_t(masks[r], dev, torch.int8), vals=_t(vals[r], dev),
        inv_perm=_inv(inv_perm, r, dev), kinds=tuple(str(k) for k in kinds),
        dists=tuple(int(d) for d in dists), chunks=_detuple(tuple(chunks)),
        shape=tuple(int(v) for v in shape), n_pad=int(n_pad), m=int(m), rps=int(rps),
        dtype=str(dtype))


def dist_routed_hier_plan_from_arrays(flat_masks, net_meta, vals, inv_perm, chunks, shape,
                                      n_pad, m, rps, bl, dtype, mesh) -> DistRoutedHierPlan:
    """flat_masks: every net's pass masks in order, each [ndev, ...];
    net_meta[b]: net b's static pass descriptors."""
    r, dev = mesh.rank, mesh.device
    net_meta = _detuple(tuple(net_meta))
    nets, off = [], 0
    for meta_b in net_meta:
        nets.append(tuple(meta + (_t(flat_masks[off + j][r], dev),)
                          for j, meta in enumerate(meta_b)))
        off += len(meta_b)
    return DistRoutedHierPlan(
        mesh=mesh, nets=tuple(nets), vals=_t(vals[r], dev),
        inv_perm=_inv(inv_perm, r, dev), chunks=_detuple(tuple(chunks)),
        shape=tuple(int(v) for v in shape), n_pad=int(n_pad), m=int(m), rps=int(rps),
        bl=int(bl), dtype=str(dtype))
