"""Distributed SpMV and solvers over a mesh of ranks.

Counterpart of lilac_tpu/parallel/dist.py. The JAX package runs a whole
solve as one shard_map program; here every rank of a torch.distributed
group (parallel/launch.py:run_spmd) runs the port's own solver loop
(solvers/cg.py, solvers/bicg.py) unchanged on its row block, and the
plan's matvec and the algebra's dot hide the collectives
(parallel/mesh.py).

Scheme (the JAX package's v1, all-gather):
  * rows padded to ndev * rps, ELL-packed with GLOBAL column ids; a rank
    holds its [rps, K] block (the JAX plan's [ndev, rps, K] shard d);
  * vectors are this rank's [rps] shard on its device: `vec_in` takes the
    host's full f64 vector, `vec_out` returns the full host vector on every
    rank (a collective: every rank calls it);
  * matvec: x_full = all-gather of the shards, then the local ELL
    gather-reduce (kernels/gather.py:ell_spmv; df64: TwoProd + pairwise
    df-sum);
  * dot products: the local partial, all-gathered, then summed in rank
    order (df64: df.sum_df over the gathered (hi, lo) pairs).

The ordered sum takes the place of `psum` on purpose: every rank adds the
same partials in the same order, so every rank holds the same bits.
cg_solve and bicg_solve read their stopping test on the host each
iteration, and ranks that disagreed in the last bit would leave the loop
at different iterations and wait forever in the next collective.
Histories come back replicated, the same bits on every rank.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Tuple

import numpy as np
import torch

from lilac_tpu_torch.formats import convert
from lilac_tpu_torch.formats.sparse import ELL
from lilac_tpu_torch.kernels import gather
from lilac_tpu_torch.ops import dfloat as df
from lilac_tpu_torch.parallel.mesh import Mesh, make_mesh  # noqa: F401
from lilac_tpu_torch.solvers.algebra import get_algebra

NP_DTYPES = {"f32": np.float32, "f64": np.float64}
TORCH_DTYPES = {"f32": torch.float32, "f64": torch.float64}


def shard_rows(n: int, ndev: int) -> Tuple[int, int]:
    """(rows per shard, padded rows) of the row-block split, as the JAX
    package pads them: rps a multiple of 8."""
    rps = convert.round_up(-(-n // ndev), 8)
    return rps, ndev * rps


def gather_pair(mesh: Mesh, hi: torch.Tensor, lo: torch.Tensor):
    """All-gather a df64 vector's two words in one collective."""
    g = mesh.all_gather_stack(torch.stack([hi, lo]))  # [size, 2, rps]
    return g[:, 0].reshape(-1), g[:, 1].reshape(-1)


def vec_shard(mesh: Mesh, x: np.ndarray, n: int, n_pad: int, rps: int, dtype: str):
    """Host f64 [n] -> this rank's [rps] shard of the zero-padded vector on
    mesh.device (df64: the host's exact (hi, lo) split)."""
    xp = np.zeros(n_pad, dtype=np.float64)
    xp[:n] = np.asarray(x, dtype=np.float64)
    local = xp[mesh.rank * rps:(mesh.rank + 1) * rps]
    if dtype == "df64":
        return df.from_f64(local, device=mesh.device)
    return torch.as_tensor(local, dtype=TORCH_DTYPES[dtype], device=mesh.device)


def vec_gather(mesh: Mesh, y, n: int) -> np.ndarray:
    """Every rank's shard of y -> the full host f64 vector [n] (on every rank)."""
    if isinstance(y, df.DF):
        hi, lo = gather_pair(mesh, y.hi, y.lo)
        return df.to_f64(df.DF(hi, lo))[:n]
    return mesh.all_gather_tiled(y).cpu().numpy().astype(np.float64)[:n]


class DistAlg:
    """Mesh-aware algebra: local elementwise ops, collective dot products."""

    def __init__(self, base, mesh: Mesh):
        self.base = base
        self.mesh = mesh
        self.dtype = getattr(base, "dtype", None)

    def dot(self, u, v):
        local = self.base.dot(u, v)
        if isinstance(local, df.DF):
            # gather the df partials and re-sum them compensated (summing hi
            # and lo apart would drop the low words)
            g = self.mesh.all_gather_stack(torch.stack([local.hi, local.lo]))
            return df.sum_df(df.DF(g[:, 0], g[:, 1]), axis=0)
        g = self.mesh.all_gather_stack(local.reshape(1))[:, 0]
        s = g[0]
        for i in range(1, self.mesh.size):  # rank order, the same on every rank
            s = s + g[i]
        return s

    def __getattr__(self, name):
        return getattr(self.base, name)


def _ell_shard(indptr, indices, vals, n: int, rps: int, rank: int):
    """This rank's [rps, K] block of the JAX plan's row-padded ELL arrays:
    K the longest row of the whole matrix, padding (index 0, value 0)."""
    counts = np.diff(indptr)
    k = max(int(counts.max()), 1) if n else 1
    r0, r1 = min(rank * rps, n), min((rank + 1) * rps, n)
    e0, e1 = int(indptr[r0]), int(indptr[r1])
    ev, ec = convert.csr_to_ell_arrays(
        np.asarray(indptr[r0:r1 + 1], dtype=np.int64) - e0, indices[e0:e1], vals[e0:e1],
        (r1 - r0, n), row_pad=rps)
    pad = ((0, 0), (0, k - ev.shape[1]))
    return np.pad(ev, pad + ((0, 0),) * (ev.ndim - 2)), np.pad(ec, pad)


@dataclasses.dataclass
class DistSpmvPlan:
    """Row-block distributed ELL plan: this rank's block of the JAX plan's
    [ndev, rps, K] arrays on mesh.device."""

    mesh: Mesh
    data: torch.Tensor  # [rps, K] (or [rps, K, 2] for df64)
    indices: torch.Tensor  # [rps, K] int64 global column ids
    shape: Tuple[int, int]
    n_pad: int
    rps: int
    dtype: str
    build_s: float = 0.0

    @staticmethod
    def build(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray,
              shape: Tuple[int, int], mesh: Mesh, *, dtype: str = "f32") -> "DistSpmvPlan":
        t0 = time.perf_counter()
        n = shape[0]
        if shape[0] != shape[1]:
            raise ValueError("distributed plan assumes square matrices")
        rps, n_pad = shard_rows(n, mesh.size)
        vals = df.split_f64_np(data) if dtype == "df64" else data.astype(NP_DTYPES[dtype])
        ev, ec = _ell_shard(indptr, indices, vals, n, rps, mesh.rank)
        return DistSpmvPlan(
            mesh=mesh,
            data=torch.as_tensor(ev, device=mesh.device),
            indices=torch.as_tensor(ec, dtype=torch.int64, device=mesh.device),
            shape=tuple(shape), n_pad=n_pad, rps=rps, dtype=dtype,
            build_s=time.perf_counter() - t0)

    # -- vectors --------------------------------------------------------

    def vec_in(self, x: np.ndarray):
        """Host f64 [n] -> this rank's [rps] shard on its device."""
        return vec_shard(self.mesh, x, self.shape[0], self.n_pad, self.rps, self.dtype)

    def vec_out(self, y) -> np.ndarray:
        """Every rank's shard -> the full host f64 vector (a collective)."""
        return vec_gather(self.mesh, y, self.shape[0])

    # -- per-rank matvec -------------------------------------------------

    def local_matvec(self, A_local, x_local):
        """A_local: a_arrays; x_local: this rank's [rps] shard."""
        data, idx = A_local
        if self.dtype == "df64":
            xh, xl = gather_pair(self.mesh, x_local.hi, x_local.lo)
            a = df.DF(data[..., 0], data[..., 1])
            t = df.mul(a, df.DF(xh[idx], xl[idx]))
            return df.sum_df(t, axis=1)
        x_full = self.mesh.all_gather_tiled(x_local)
        return gather.ell_spmv(ELL(data=data, indices=idx, shape=(self.rps, self.n_pad)),
                               x_full)

    def alg(self) -> DistAlg:
        return DistAlg(get_algebra(self.dtype, self.mesh.device), self.mesh)

    @property
    def a_arrays(self):
        return (self.data, self.indices)


def dist_npb_power_method(plan, x0, shift: float, niter: int):
    """NPB outer power iteration on every rank. x0 from plan.vec_in(...).
    Returns (zetas, rnorms, x_final): the histories replicated, x_final this
    rank's shard."""
    from lilac_tpu_torch.solvers.cg import npb_power_method

    return npb_power_method(plan.local_matvec, plan.alg(), plan.a_arrays, x0, shift, niter)


def dist_cg_solve(plan, b, *, maxit=100, rtol=1e-6):
    """General CG over the mesh (SparseBench semantics, distributed).
    Returns (x shard, iterations, rnorm)."""
    from lilac_tpu_torch.solvers.cg import cg_solve

    return cg_solve(plan.local_matvec, plan.alg(), plan.a_arrays, b, maxit=maxit, rtol=rtol)


def dist_transposed_plan(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray,
                         shape: Tuple[int, int], mesh: Mesh, **kw) -> DistSpmvPlan:
    """Aᵀ staged as its own row-block distributed plan (host CSC
    transpose), so both product directions keep the all-gather + local
    gather-reduce path under every value policy."""
    rows = np.repeat(np.arange(shape[0], dtype=np.int64), np.diff(indptr))
    t_ip, t_ix, t_v = convert.coo_to_csr_arrays(indices, rows, data, (shape[1], shape[0]))
    return DistSpmvPlan.build(t_ip, t_ix, t_v, (shape[1], shape[0]), mesh, **kw)


def dist_bicg_solve(plan: DistSpmvPlan, plan_t: DistSpmvPlan, b, *, maxit: int = 100,
                    rtol: float = 1e-6):
    """Distributed BiCG (SparseBench iter.f semantics) with the exact staged
    Aᵀ. Returns (x shard, its, hist, rnorm)."""
    from lilac_tpu_torch.solvers.bicg import bicg_solve

    x0 = plan.alg().zeros_like(b)
    x, its, hist, rn, _state = bicg_solve(
        lambda pair, v: plan.local_matvec(pair[0], v),
        lambda pair, v: plan_t.local_matvec(pair[1], v),
        plan.alg(), (plan.a_arrays, plan_t.a_arrays), b, x0, maxit=maxit, rtol=rtol)
    return x, its, hist, rn
