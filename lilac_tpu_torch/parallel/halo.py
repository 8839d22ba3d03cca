"""Halo-exchange distributed SpMV: ring shifts instead of an all-gather.

Counterpart of lilac_tpu/parallel/halo.py. DistSpmvPlan (dist.py)
all-gathers x every matvec, which suits matrices whose row blocks reach
most columns (NPB CG). For matrices with column locality (stencils) each
block's columns outside its own rows are a thin halo; this plan computes,
per ring distance k, exactly which x entries travel, and exchanges them
with one ring shift each (parallel/mesh.py:ring_shift, `lax.ppermute`).

Per-DISTANCE halos: the exchange for ring distance k is padded to
H_k = the largest over source ranks of that distance's segment, and
distances nobody references are skipped, so a 1-D-sharded stencil does
two neighbour shifts (k = 1 and ndev - 1).

Ghost layout: the kept distances' segments follow the local block in
distance order, and the ELL column ids are remapped at build time into
the [local | ghost] space.

The tables are host numpy, built from every rank's rows on every rank,
bit for bit the JAX package's; each rank keeps its own row.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Tuple

import numpy as np
import torch

from lilac_tpu_torch.formats import convert
from lilac_tpu_torch.parallel.dist import NP_DTYPES, DistAlg, shard_rows, vec_gather, vec_shard
from lilac_tpu_torch.parallel.mesh import Mesh
from lilac_tpu_torch.solvers.algebra import get_algebra


def halo_tables(ev, ec, ndev: int, rps: int):
    """Per-distance halo bookkeeping from the row-block ELL split.

    ev/ec: [ndev, rps, K] ELL values / global column ids.
    Returns (dist_ks, halos, send_tbls, new_ec):
      dist_ks : kept ring distances (k: src s -> dst (s+k) % ndev)
      halos   : H_k per kept distance
      send_tbls: [ndev, H_k] int64 local positions each src sends at k
      new_ec  : ELL ids remapped into [local rps | ghost segments]
    """
    owner = ec // rps
    needed = {}  # (dst, src) -> sorted unique local positions on src
    used_mask = ev != 0.0 if ev.ndim == 3 else (ev[..., 0] != 0.0)
    for d in range(ndev):
        for s in range(ndev):
            if s == d:
                continue
            sel = used_mask[d] & (owner[d] == s)
            cols = np.unique(ec[d][sel]) if sel.any() else np.empty(0, np.int64)
            needed[(d, s)] = cols - s * rps

    dist_ks, halos, send_tbls = [], [], []
    for k in range(1, ndev):
        H_k = max(len(needed[((s + k) % ndev, s)]) for s in range(ndev))
        if H_k == 0:
            continue
        tbl = np.zeros((ndev, H_k), dtype=np.int64)
        for s in range(ndev):
            pos = needed[((s + k) % ndev, s)]
            tbl[s, : len(pos)] = pos
        dist_ks.append(k)
        halos.append(H_k)
        send_tbls.append(tbl)

    off = {}
    acc = rps
    for k, H_k in zip(dist_ks, halos):
        off[k] = acc
        acc += H_k

    new_ec = np.zeros_like(ec)
    for d in range(ndev):
        local = owner[d] == d
        new_ec[d] = np.where(local, ec[d] - d * rps, 0)
        for k in dist_ks:
            s = (d - k) % ndev
            pos = needed[(d, s)]
            lookup = np.zeros(rps, dtype=np.int64)
            lookup[pos] = off[k] + np.arange(len(pos))
            sel = owner[d] == s
            new_ec[d] = np.where(
                sel, lookup[np.clip(ec[d] - s * rps, 0, rps - 1)], new_ec[d]
            )
        # padding slots (value 0) may point anywhere valid
    return tuple(dist_ks), tuple(halos), send_tbls, new_ec


def halo_host(indptr, indices, data, shape, ndev: int, dtype: str):
    """The whole mesh's halo plan on the host: (rps, n_pad, ev [ndev, rps,
    K], new_ec [ndev, rps, K] int64, dist_ks, halos, send_tbls), the arrays
    HaloSpmvPlan.build of the JAX package puts on its mesh."""
    n = shape[0]
    if shape[0] != shape[1]:
        raise ValueError("distributed plan assumes square matrices")
    rps, n_pad = shard_rows(n, ndev)
    ev, ec = convert.csr_to_ell_arrays(
        indptr, indices, data.astype(NP_DTYPES[dtype]), shape, row_pad=n_pad)
    K = ev.shape[1]
    ev = ev.reshape(ndev, rps, K)
    ec = ec.reshape(ndev, rps, K).astype(np.int64)
    dist_ks, halos, send_tbls, new_ec = halo_tables(ev, ec, ndev, rps)
    return rps, n_pad, ev, new_ec, dist_ks, halos, send_tbls


def ghost_concat(mesh: Mesh, dist_ks, x_local: torch.Tensor, sends) -> torch.Tensor:
    """x_ext = [local | per-distance ghosts], one ring shift per kept
    distance. x_local's last axis is the vector ([rps], or [2, rps] for a
    df64 pair moved in one message)."""
    ghosts = [mesh.ring_shift(x_local[..., send], k) for k, send in zip(dist_ks, sends)]
    return torch.cat([x_local] + ghosts, dim=-1) if ghosts else x_local


@dataclasses.dataclass
class HaloSpmvPlan:
    """Row-block ELL plan with ring halo exchange (f32 / f64): this rank's
    rows of the JAX plan's arrays."""

    mesh: Mesh
    data: torch.Tensor  # [rps, K]
    indices: torch.Tensor  # [rps, K] int64 ids into [local | ghost]
    send_tbls: Tuple[torch.Tensor, ...]  # per kept distance [H_k] int64
    dist_ks: Tuple[int, ...]
    halos: Tuple[int, ...]
    shape: Tuple[int, int]
    n_pad: int
    rps: int
    dtype: str
    build_s: float = 0.0

    @property
    def halo(self) -> int:
        """Largest per-distance halo (0 when no exchange is needed)."""
        return max(self.halos, default=0)

    @property
    def total_ghost(self) -> int:
        return sum(self.halos)

    @staticmethod
    def build(indptr, indices, data, shape, mesh: Mesh, *, dtype="f32") -> "HaloSpmvPlan":
        t0 = time.perf_counter()
        rps, n_pad, ev, new_ec, dist_ks, halos, send_tbls = halo_host(
            indptr, indices, data, shape, mesh.size, dtype)
        r, dev = mesh.rank, mesh.device
        return HaloSpmvPlan(
            mesh=mesh,
            data=torch.as_tensor(ev[r], device=dev),
            indices=torch.as_tensor(new_ec[r], device=dev),
            send_tbls=tuple(torch.as_tensor(t[r], device=dev) for t in send_tbls),
            dist_ks=dist_ks, halos=halos, shape=tuple(shape), n_pad=n_pad, rps=rps,
            dtype=dtype, build_s=time.perf_counter() - t0)

    # -- vectors ---------------------------------------------------------

    def vec_in(self, x: np.ndarray):
        return vec_shard(self.mesh, x, self.shape[0], self.n_pad, self.rps, self.dtype)

    def vec_out(self, y) -> np.ndarray:
        return vec_gather(self.mesh, y, self.shape[0])

    # -- per-rank matvec ---------------------------------------------------

    def local_matvec(self, A_local, x_local):
        data, idx = A_local[0], A_local[1]
        x_ext = ghost_concat(self.mesh, self.dist_ks, x_local, A_local[2:])
        return (data * x_ext[idx]).sum(dim=1)

    def alg(self) -> DistAlg:
        return DistAlg(get_algebra(self.dtype, self.mesh.device), self.mesh)

    @property
    def a_arrays(self):
        return (self.data, self.indices) + self.send_tbls


def halo_matvec(plan: HaloSpmvPlan, x):
    """This rank's shard of A x (every rank calls it)."""
    return plan.local_matvec(plan.a_arrays, x)
