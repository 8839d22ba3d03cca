"""Distributed SpMV through per-shard routing networks.

Counterpart of lilac_tpu/parallel/dist_routed.py. Row-block distribution
as in parallel/dist.py (all-gather x, ordered-sum dot products), with each
rank's gather run through plan-time routing networks (kernels/routenet.py
and kernels/routed.py) instead of torch's index kernel: the multi-rank face
of the routed kernels.

The JAX package traces ONE shard_map program for every device, so every
shard's networks must share one static schedule. The port keeps that
schedule, which is also what makes its plans the JAX package's arrays:

  1. every shard's networks come from ONE batched `build_gather_network`
     call (drop_empty=False), so (kinds, dists) are canonical and a shard
     differs only in its mask stack [B, P, R, 128] and its values;
  2. the row-chunk schedule ((rows_c, K_c) per network) is cut from the
     ELEMENTWISE-MAX length profile across shards (each shard sorts its
     rows by length, descending), so one chunk tuple covers every shard.

So the builds are global on the host: every rank runs the same build on
the full CSR and keeps its own slice on its device (a deliberate
repetition: a build per rank and a broadcast of its slices would each
cost a transport of the plan; `build_s` is each rank's own).

Kernels: `DistRoutedPlan` and `HaloRoutedPlan` run K1 (routed_apply,
csrc/routed.cu) over one table per rank; `DistRoutedHierPlan` runs the
per-net hierarchical passes K3u-K6u (hier_apply, csrc/hier.cu). The row
sums after the gather stay plain torch (df.mul + sum_df), as the JAX
package's `_finish_routed_matvec` does.

HaloRoutedPlan feeds the ring halo exchange of parallel/halo.py into
per-rank networks whose input table is the small [local | ghost] vector
instead of the all-gathered x.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from lilac_tpu_torch.kernels import routed as rd
from lilac_tpu_torch.kernels import routenet as rn
from lilac_tpu_torch.kernels.routed_spmv import (
    _chunk_reduce,
    _hier_gmax_cfg,
    _pow2_at_least,
    hier_bl_cfg,
)
from lilac_tpu_torch.ops import dfloat as df
from lilac_tpu_torch.parallel.dist import (
    NP_DTYPES,
    DistAlg,
    gather_pair,
    shard_rows,
    vec_gather,
    vec_shard,
)
from lilac_tpu_torch.parallel.halo import ghost_concat, halo_host
from lilac_tpu_torch.parallel.mesh import Mesh
from lilac_tpu_torch.solvers.algebra import get_algebra


def _common_chunk_schedule(counts: np.ndarray, m: int):
    """Static (rows_c, K_c) chunks valid for EVERY shard.

    counts: [ndev, rps] row lengths in each shard's packing order. The
    max-profile over shards bounds position p's width, so chunks cut from
    it fit all shards (greedy, K widened to the true in-chunk max as in
    build_routed_csr).
    """
    profile = counts.max(axis=0)
    rps = len(profile)
    chunks = []
    i0 = 0
    while i0 < rps:
        k_c = max(int(profile[i0]), 1)
        rows_c = min(m // k_c, rps - i0)
        k_true = max(int(profile[i0 : i0 + rows_c].max()), 1)
        if k_true > k_c:
            rows_c = min(m // k_true, rps - i0)
            k_c = max(int(profile[i0 : i0 + rows_c].max()), 1)
        chunks.append((rows_c, k_c))
        i0 += rows_c
    return tuple(chunks)


def _pack_shard_chunks(
    indptr, indices, data, shape, ndev, *, dtype, m_floor, sort_rows=True
):
    """Shared shard / sort / chunk-schedule / slot packing for the routed
    distributed plans. Returns a dict with:
      rps, n_pad, m, sort_rows (resolved), rank [ndev, rps],
      chunks ((rows_c, K_c), ...), base [ndev*B, m] gather indices laid
      out d-major (row d*B+b), vals [ndev, B, m(,2)] slot-ordered values.
    """
    n = shape[0]
    if shape[0] != shape[1]:
        raise ValueError("distributed plan assumes square matrices")
    rps, n_pad = shard_rows(n, ndev)
    counts = np.zeros(n_pad, dtype=np.int64)
    counts[:n] = np.diff(indptr)
    counts2 = counts.reshape(ndev, rps)
    kmax = max(int(counts.max()), 1)
    m = max(m_floor, _pow2_at_least(max(n_pad, kmax)))

    if sort_rows == "auto":
        sort_rows = bool(kmax > 1.25 * max(counts.mean(), 1.0) + 2)
    if sort_rows:
        order = np.argsort(-counts2, axis=1, kind="stable")  # [ndev, rps]
        if np.array_equal(order, np.tile(np.arange(rps), (ndev, 1))):
            sort_rows = False
    if not sort_rows:
        order = np.tile(np.arange(rps), (ndev, 1))
    rank = np.empty_like(order)
    np.put_along_axis(rank, order, np.tile(np.arange(rps), (ndev, 1)), axis=1)
    sorted_counts = np.take_along_axis(counts2, order, axis=1)

    chunks = _common_chunk_schedule(sorted_counts, m)
    B = len(chunks)
    chunk_of = np.empty(rps, dtype=np.int64)
    slot0_of = np.empty(rps, dtype=np.int64)
    p0 = 0
    for b, (rows_c, k_c) in enumerate(chunks):
        chunk_of[p0 : p0 + rows_c] = b
        slot0_of[p0 : p0 + rows_c] = np.arange(rows_c) * k_c
        p0 += rows_c

    if dtype == "df64":
        dvals = df.split_f64_np(data)
    else:
        dvals = data.astype(NP_DTYPES[dtype])

    rows_rep = np.repeat(np.arange(n), np.diff(indptr))
    slot_in_row = np.arange(len(indices)) - np.repeat(
        indptr[:-1], np.diff(indptr)
    )
    d_e = rows_rep // rps
    p_e = rank[d_e, rows_rep % rps]
    b_e = chunk_of[p_e]
    t_e = slot0_of[p_e] + slot_in_row

    base = np.tile(np.arange(m, dtype=np.int64) % n_pad, (ndev * B, 1))
    base[d_e * B + b_e, t_e] = indices
    vals = np.zeros((ndev, B, m) + dvals.shape[1:], dtype=dvals.dtype)
    vals[d_e, b_e, t_e] = dvals
    return dict(
        rps=rps, n_pad=n_pad, m=m, sort_rows=sort_rows, rank=rank,
        chunks=chunks, base=base, vals=vals,
    )


def _check_table(m: int, B: int, plan: str) -> None:
    rd.check_table_feasible(
        m, B, what=f"{plan} (one table of m={m} slots, {B} nets a shard; a larger "
        "shard table takes DistRoutedHierPlan)")


def _shard_masks(net, rank: int, B: int) -> np.ndarray:
    """This rank's B networks of a batched build, bit-packed [B, P, R, 128]."""
    return rd.masks_packed(net.masks[:, rank * B:(rank + 1) * B])


def _route_planes(planes, m: int):
    """Vectors zero-padded to the m-slot table as [m // 128, 128] planes."""
    return [F.pad(p, (0, m - p.shape[0])).reshape(m // 128, 128) for p in planes]


def _finish_routed_matvec(plan, g_planes, vals, inv):
    """Shared tail: slot-ordered values x routed gather -> per-chunk
    K-axis reduce -> optional un-permute. g_planes: [B, m] per value
    plane; vals: the shard's [B, m(,2)] block."""
    if plan.dtype == "df64":
        gh, gl = g_planes
        a = df.DF(vals[..., 0], vals[..., 1])
        prod = df.mul(a, df.DF(gh, gl))
        his, los = [], []
        for c, (rows_c, k_c) in enumerate(plan.chunks):
            t = df.sum_df(
                df.DF(
                    prod.hi[c, : rows_c * k_c].reshape(rows_c, k_c),
                    prod.lo[c, : rows_c * k_c].reshape(rows_c, k_c),
                ),
                axis=1,
            )
            his.append(t.hi)
            los.append(t.lo)
        hi, lo = torch.cat(his), torch.cat(los)
        if inv is not None:
            return df.DF(hi[inv], lo[inv])
        return df.DF(hi, lo)
    (g,) = g_planes
    y = _chunk_reduce(vals * g, plan.chunks, plan.m)
    return y if inv is None else y[inv]


class _RowBlockVectors:
    """vec_in / vec_out / alg of the row-block plans (parallel/dist.py's
    conventions)."""

    def vec_in(self, x: np.ndarray):
        return vec_shard(self.mesh, x, self.shape[0], self.n_pad, self.rps, self.dtype)

    def vec_out(self, y) -> np.ndarray:
        return vec_gather(self.mesh, y, self.shape[0])

    def alg(self) -> DistAlg:
        return DistAlg(get_algebra(self.dtype, self.mesh.device), self.mesh)

    def _gathered_planes(self, x_local):
        """The all-gathered x as the networks' value planes."""
        if self.dtype == "df64":
            return gather_pair(self.mesh, x_local.hi, x_local.lo)
        return (self.mesh.all_gather_tiled(x_local),)


@dataclasses.dataclass
class DistRoutedPlan(_RowBlockVectors):
    mesh: Mesh
    masks: torch.Tensor  # [B, P, R, 128] int8, this rank's nets
    vals: torch.Tensor  # [B, m] (or [B, m, 2])
    inv_perm: Optional[torch.Tensor]  # [rps] int64 or None (no sort)
    kinds: Tuple[str, ...]
    dists: Tuple[int, ...]
    chunks: Tuple[Tuple[int, int], ...]
    shape: Tuple[int, int]
    n_pad: int
    m: int
    rps: int
    dtype: str
    build_s: float = 0.0

    @staticmethod
    def build(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray,
              shape: Tuple[int, int], mesh: Mesh, *, dtype: str = "f32",
              sort_rows="auto") -> "DistRoutedPlan":
        from lilac_tpu_torch.config import cfg

        t0 = time.perf_counter()
        ndev, r, dev = mesh.size, mesh.rank, mesh.device
        pk = _pack_shard_chunks(
            indptr, indices, data, shape, ndev, dtype=dtype, m_floor=1024,
            sort_rows=sort_rows,
        )
        m, chunks = pk["m"], pk["chunks"]
        B = len(chunks)
        _check_table(m, B, "DistRoutedPlan")
        # single-table per-shard nets: the batched build shares one canonical
        # stage list across shards
        net = rn.build_gather_network(
            pk["base"], pk["n_pad"], m, drop_empty=False, mode=cfg().net_mode
        )
        return DistRoutedPlan(
            mesh=mesh,
            masks=torch.as_tensor(_shard_masks(net, r, B), device=dev),
            vals=torch.as_tensor(pk["vals"][r], device=dev),
            inv_perm=(torch.as_tensor(pk["rank"][r], dtype=torch.int64, device=dev)
                      if pk["sort_rows"] else None),
            kinds=net.kinds, dists=net.dists, chunks=chunks, shape=tuple(shape),
            n_pad=pk["n_pad"], m=m, rps=pk["rps"], dtype=dtype,
            build_s=time.perf_counter() - t0)

    def _route(self, masks, planes):
        B = len(self.chunks)
        outs = rd.routed_apply(_route_planes(planes, self.m), masks, self.kinds, self.dists)
        return [o.reshape(B, self.m) for o in outs]

    def local_matvec(self, A_local, x_local):
        masks, vals, inv = A_local
        g = self._route(masks, self._gathered_planes(x_local))
        return _finish_routed_matvec(self, g, vals, inv)

    @property
    def a_arrays(self):
        return (self.masks, self.vals, self.inv_perm)


def hier_nets_host(base: np.ndarray, ndev: int, B: int, n_pad: int, m: int, bl: int,
                   gmax: int):
    """Every shard's hierarchical networks, on the host: (net_meta, flat
    masks). For each net index b the ndev shards' networks come from ONE
    batched build_gather_network call, so compile_hier gives every shard
    the same pass schedule (checked); net_meta[b] is that schedule's
    static descriptors, and flat masks[(b, j)] pass j's masks of every
    shard stacked [ndev, ...], as the JAX plan's flat_masks."""
    flat_masks, net_meta = [], []
    for b in range(B):
        net_b = rn.build_gather_network(base[b::B], n_pad, m, drop_empty=False)
        per_dev = [
            rd.compile_hier(net_b.kinds, net_b.dists, net_b.masks[:, d, :], bl, gmax=gmax)
            for d in range(ndev)
        ]
        meta_b = tuple(p[:-1] for p in per_dev[0])
        for pd in per_dev[1:]:
            if tuple(p[:-1] for p in pd) != meta_b:
                raise AssertionError("hier pass schedule diverged across shards")
        net_meta.append(meta_b)
        for j in range(len(meta_b)):
            flat_masks.append(np.stack([pd[j][-1] for pd in per_dev]))
    return tuple(net_meta), flat_masks


@dataclasses.dataclass
class DistRoutedHierPlan(_RowBlockVectors):
    """Per-shard HIERARCHICAL routing networks.

    DistRoutedPlan's networks are one table a rank. This plan runs each
    net's stages the way the single-card RoutedMatHier does
    (kernels/routed_spmv.py): distances below `bl` as inner passes over a
    block held on chip, longer ones as butterfly / window / block-aligned
    shift passes over device memory, one net at a time (K3u-K6u). `bl`
    defaults to LILAC_HIER_BL or the card's own (kernels/routed.py:
    default_hier_bl, 2^13 on an H100), not the JAX package's 2^16."""

    mesh: Mesh
    nets: Tuple[tuple, ...]  # per net: its passes, each meta + (mask tensor,)
    vals: torch.Tensor  # [B, m] (or [B, m, 2])
    inv_perm: Optional[torch.Tensor]  # [rps] or None
    chunks: Tuple[Tuple[int, int], ...]
    shape: Tuple[int, int]
    n_pad: int
    m: int
    rps: int
    bl: int
    dtype: str
    build_s: float = 0.0

    @property
    def net_meta(self) -> Tuple[tuple, ...]:
        """Per net, its passes' static descriptors (the same on every rank)."""
        return tuple(tuple(p[:-1] for p in passes) for passes in self.nets)

    @staticmethod
    def build(indptr, indices, data, shape, mesh: Mesh, *, dtype: str = "f32",
              bl: int | None = None) -> "DistRoutedHierPlan":
        t0 = time.perf_counter()
        bl = hier_bl_cfg() if bl is None else int(bl)
        ndev, r, dev = mesh.size, mesh.rank, mesh.device
        pk = _pack_shard_chunks(
            indptr, indices, data, shape, ndev, dtype=dtype, m_floor=2 * bl,
            sort_rows=True,
        )
        m, chunks = pk["m"], pk["chunks"]
        B = len(chunks)
        net_meta, flat = hier_nets_host(pk["base"], ndev, B, pk["n_pad"], m, bl,
                                        _hier_gmax_cfg(bl, dtype))
        nplanes, esize = (2, 4) if dtype == "df64" else (1, 8 if dtype == "f64" else 4)
        nets, off = [], 0
        for meta_b in net_meta:
            rd.check_smem_feasible(meta_b, bl, nplanes, esize,
                                   limit=rd.smem_optin_bytes(dev),
                                   what=f"DistRoutedHierPlan bl={bl}")
            nets.append(tuple(
                meta + (torch.as_tensor(flat[off + j][r], device=dev),)
                for j, meta in enumerate(meta_b)))
            off += len(meta_b)
        return DistRoutedHierPlan(
            mesh=mesh, nets=tuple(nets),
            vals=torch.as_tensor(pk["vals"][r], device=dev),
            inv_perm=(torch.as_tensor(pk["rank"][r], dtype=torch.int64, device=dev)
                      if pk["sort_rows"] else None),
            chunks=chunks, shape=tuple(shape), n_pad=pk["n_pad"], m=m,
            rps=pk["rps"], bl=bl, dtype=dtype, build_s=time.perf_counter() - t0)

    def _route(self, nets, planes):
        pads = _route_planes(planes, self.m)
        per_plane = [[] for _ in planes]
        for passes in nets:
            for i, o in enumerate(rd.hier_apply(pads, passes, self.bl)):
                per_plane[i].append(o.reshape(self.m))
        return [torch.stack(o) for o in per_plane]  # [B, m] per plane

    def local_matvec(self, A_local, x_local):
        vals, inv, nets = A_local
        g = self._route(nets, self._gathered_planes(x_local))
        return _finish_routed_matvec(self, g, vals, inv)

    @property
    def a_arrays(self):
        return (self.vals, self.inv_perm, self.nets)


# ---------------------------------------------------------------------------
# halo exchange x routed gather
# ---------------------------------------------------------------------------


def halo_routed_host(indptr, indices, data, shape, ndev: int, dtype: str):
    """The whole mesh's HaloRoutedPlan on the host: the halo plan's tables
    (parallel/halo.py:halo_host; every shard's remapped ids) packed into
    per-shard networks over the [local | ghost] table. Returns (halo
    tables, T, m, chunks, base [ndev*B, m], vals [ndev, B, m(,2)])."""
    hp = halo_host(indptr, indices, data, shape, ndev,
                   "f64" if dtype in ("f64", "df64") else "f32")
    rps, _, ev, ec, _, halos, _ = hp
    T = rps + sum(halos)  # per-shard table length
    ev64 = ev.astype(np.float64)
    K = ec.shape[2]
    m = max(1024, _pow2_at_least(max(T, K)))

    if dtype == "df64":
        dvals = df.split_f64_np(ev64.reshape(-1)).reshape(ndev, rps, K, 2)
    else:
        dvals = ev64.astype(NP_DTYPES[dtype])

    counts = np.full((ndev, rps), K, dtype=np.int64)  # ELL-uniform
    chunks = _common_chunk_schedule(counts, m)
    B = len(chunks)
    base = np.tile(np.arange(m, dtype=np.int64) % T, (ndev * B, 1))
    vals = np.zeros(
        (ndev, B, m) + (dvals.shape[3:] if dvals.ndim > 3 else ()),
        dtype=dvals.dtype,
    )
    p0 = 0
    for b, (rows_c, k_c) in enumerate(chunks):
        seg_i = ec[:, p0 : p0 + rows_c, :]  # [ndev, rows_c, K]
        seg_v = dvals[:, p0 : p0 + rows_c]
        # base[b::B] rows are d*B+b: laid out d-major (net of shard d,
        # chunk b, at row d*B+b), as the per-shard masks are read
        base[b :: B, : rows_c * k_c] = seg_i.reshape(ndev, rows_c * K)
        vals[:, b, : rows_c * k_c] = seg_v.reshape(
            (ndev, rows_c * K) + seg_v.shape[3:]
        )
        p0 += rows_c
    return hp, T, m, chunks, base, vals


@dataclasses.dataclass
class HaloRoutedPlan(_RowBlockVectors):
    """Ring halo exchange feeding per-shard routing networks (K1).

    The network input table is [local rps | ghosts]: for column-local
    matrices (stencils) far smaller than the all-gathered x, so the networks
    are shallower AND only the thin halo travels."""

    mesh: Mesh
    masks: torch.Tensor  # [B, P, R, 128]
    vals: torch.Tensor  # [B, m] (or [B, m, 2])
    send_tbls: Tuple[torch.Tensor, ...]  # per kept ring distance [H_k]
    dist_ks: Tuple[int, ...]
    halos: Tuple[int, ...]
    kinds: Tuple[str, ...]
    dists: Tuple[int, ...]
    chunks: Tuple[Tuple[int, int], ...]
    shape: Tuple[int, int]
    n_pad: int
    m: int
    rps: int
    dtype: str
    build_s: float = 0.0

    @property
    def total_ghost(self) -> int:
        return sum(self.halos)

    @staticmethod
    def build(indptr, indices, data, shape, mesh: Mesh, *, dtype="f32") -> "HaloRoutedPlan":
        from lilac_tpu_torch.config import cfg

        t0 = time.perf_counter()
        ndev, r, dev = mesh.size, mesh.rank, mesh.device
        hp, T, m, chunks, base, vals = halo_routed_host(
            indptr, indices, data, shape, ndev, dtype)
        rps, n_pad, _, _, dist_ks, halos, send_tbls = hp
        B = len(chunks)
        _check_table(m, B, "HaloRoutedPlan")
        net = rn.build_gather_network(base, T, m, drop_empty=False, mode=cfg().net_mode)
        return HaloRoutedPlan(
            mesh=mesh,
            masks=torch.as_tensor(_shard_masks(net, r, B), device=dev),
            vals=torch.as_tensor(vals[r], device=dev),
            send_tbls=tuple(torch.as_tensor(t[r], device=dev) for t in send_tbls),
            dist_ks=dist_ks, halos=halos, kinds=net.kinds, dists=net.dists,
            chunks=chunks, shape=tuple(shape), n_pad=n_pad, m=m, rps=rps,
            dtype=dtype, build_s=time.perf_counter() - t0)

    _route = DistRoutedPlan._route

    def local_matvec(self, A_local, x_local):
        masks, vals, sends = A_local[0], A_local[1], A_local[2:]
        if self.dtype == "df64":
            # hi and lo travel as one [2, H_k] message a distance
            x_ext = ghost_concat(self.mesh, self.dist_ks,
                                 torch.stack([x_local.hi, x_local.lo]), sends)
            g = self._route(masks, (x_ext[0], x_ext[1]))
        else:
            g = self._route(masks, (ghost_concat(self.mesh, self.dist_ks, x_local, sends),))
        return _finish_routed_matvec(self, g, vals, None)

    @property
    def a_arrays(self):
        return (self.masks, self.vals) + self.send_tbls
