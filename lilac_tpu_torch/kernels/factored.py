"""Factored SpMV for sum-of-sparse-outer-products matrices (NPB CG).

Counterpart of lilac_tpu/kernels/factored.py. The NPB CG matrix is
assembled as A = sum_i s_i a_i a_i^T + (rcond - shift) I with each a_i
holding only nonzer+1 nonzeros (cg.f:650-905). The assembled matrix has
about (nonzer+1)^2 nonzeros per row, but the FACTORED product

    A x = V^T (s * (V x)) + d0 x        (V = stacked a_i^T)

needs two narrow sparse passes: about (nonzer+1)/2 times fewer gathered
elements than the assembled form.

Four layouts are ported:

* ``routed``: V and V^T as routed plans (kernels/routed_spmv.py, the
  hand-written CUDA kernels): single-table for n <= 2^18 (NPB classes S to
  C), hierarchical beyond (classes D and E). ``factored_vt=plan`` gives V^T
  a dedicated forward plan; ``factored_vt=adj`` holds V's plan only and
  applies V^T by running it in reverse (the adjoint kernels), at half the
  plan bytes. ``auto`` is ``adj`` for the hierarchical classes and ``plan``
  for the single-table ones (small plans, and a dedicated forward schedule
  has no add-merge stages).
* ``single``: V and V^T as single-segment SegBucketELL through plain torch
  indexing (kernels/gather.py). No hand kernel: the independent operator
  the routed one is held against.
* ``scan``: V and V^T as SegELLScan, columns cut into segments of SEG_SIZE
  and accumulated one segment at a time (kernels/gather.py), so that a
  product's temporaries stay one segment's slab: the reference's
  memory-bounded gather layout for the large classes. No hand kernel.
* ``mixed``: V as a hierarchical routed plan (always, whatever n; the same
  plan file as ``routed`` at the hierarchical classes), V^T as a gather
  layout: the jagged-diagonal JagELLT in df64 (kernels/gather.py:
  jag_ellt_spmv_df), a single-segment SegBucketELL in f32 / f64. One plan
  resident instead of two, with a forward-only V^T.

``factored_segmode=auto`` is ``routed`` when the plan's device is CUDA and
``single`` on the CPU. ``mixed`` with ``adj`` is ``routed``, as in the
reference: adj removes the reason mixed exists. Unlike the reference, the
port takes ``mixed`` only when it is asked for: the reference switches
``routed`` with a V^T plan to ``mixed`` beyond n = 2^21 because two class-E
plans overflow a 16 GB TPU, a limit that is not this card's.

Exactly the same matrix: summation order differs from the assembled CSR
by O(eps), far inside the zeta tolerance of 1e-10. Supports the f32 / f64
/ df64 value policies.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple, Union

import numpy as np
import torch

from lilac_tpu_torch.formats.sparse import JagELLT, SegBucketELL, SegELLScan
from lilac_tpu_torch.kernels.gather import (
    jag_ellt_spmv_df,
    seg_bucket_ell_spmv,
    seg_bucket_ell_spmv_df,
    seg_ell_scan_spmv,
    seg_ell_scan_spmv_df,
)
from lilac_tpu_torch.kernels import routed_spmv as _rs
from lilac_tpu_torch.kernels.routed_spmv import (
    RoutedMat,
    RoutedMatHierP,
    RoutedMatSeg,
    hier_bl_cfg,
    build_routed_csr,
    build_routed_csr_hier,
    maybe_pack_hier,
    plan_tag,
    routed_hier_spmv,
    routed_hier_spmv_adj_t,
    routed_hier_spmv_adj_t_df,
    routed_hier_spmv_df,
    routed_seg_spmv,
    routed_seg_spmv_df,
    routed_spmv,
    routed_spmv_adj_t,
    routed_spmv_adj_t_df,
    routed_spmv_df,
    save_routed,
)
from lilac_tpu_torch.ops import dfloat as df
from lilac_tpu_torch.utils.profiling import BUILD, span

_MATVEC = span("lilac.operator.matvec")
_V = span("lilac.operator.V")
_VT = span("lilac.operator.VT")  # VT's own plan, or V's run in reverse
_PLAN_READ = span("lilac.build.plan.read", BUILD)  # the sidecar of s and nnz_eff
_PLAN_MAKEA = span("lilac.build.plan.makea", BUILD)
_PLAN_ROUTE = span("lilac.build.plan.route", BUILD)

# Columns a segment of the scan layout. A layout constant: it fixes the
# order of the sums the tests compare with the reference. The value is the
# reference's, chosen for the TPU's gather (a 1.25 MB table a segment); it
# has not been tuned on an H100.
SEG_SIZE = 163840


@dataclasses.dataclass
class FactoredNPB:
    """Device containers for the factored operator."""

    # [n x n] sparse with rows a_i, and its transpose; VT None
    # (factored_vt=adj) = apply V's own routed plan in reverse
    V: Union[RoutedMat, RoutedMatHierP, RoutedMatSeg, SegBucketELL, SegELLScan]
    VT: Union[RoutedMat, RoutedMatHierP, RoutedMatSeg, SegBucketELL, SegELLScan,
              JagELLT, None]
    s: torch.Tensor  # [n] outer-product weights (f32/f64 or [n, 2] df)
    d0: torch.Tensor  # scalar diagonal shift rcond - shift (or [2] df)


def to_vals(v: np.ndarray, dtype: str) -> np.ndarray:
    """Host f64 values in the storage form of a value policy."""
    v = np.asarray(v, dtype=np.float64)
    if dtype == "df64":
        return df.split_f64_np(v)
    return v.astype({"f32": np.float32, "f64": np.float64}[dtype])


def _resolve_modes(conf, n: int, device) -> Tuple[str, str]:
    """(factored_segmode, factored_vt) with every `auto` resolved."""
    mode = conf.factored_segmode
    if mode == "auto":
        mode = "routed" if torch.device(device).type == "cuda" else "single"
    vt_mode = conf.factored_vt
    if vt_mode == "auto":
        # one hier plan for both directions beyond a single table; the
        # single-table classes keep the dedicated VT plan
        vt_mode = ("adj" if mode in ("routed", "mixed") and n > _rs.SINGLE_TABLE_MAX
                   else "plan")
    if vt_mode not in ("plan", "adj"):
        raise ValueError(f"unknown factored_vt {vt_mode!r}")
    if mode == "mixed" and vt_mode == "adj":
        mode = "routed"  # adj removes the reason mixed exists
    if mode not in ("routed", "mixed", "single", "scan"):
        raise ValueError(f"unknown factored_segmode {mode!r}")
    if mode != "routed":
        vt_mode = "plan"  # a gather layout has no network to run in reverse
    return mode, vt_mode


def _build_hier_plan(path, indptr, indices, vals, n, dtype, device):
    with _PLAN_ROUTE:
        M = build_routed_csr_hier(
            indptr, indices, vals, (n, n), dtype=dtype, bl=hier_bl_cfg(), verbose=True)
        save_routed(path, M)
    return maybe_pack_hier(M, device)


def build_factored(
    class_name: str, dtype: str = "f64", device="cuda"
) -> Tuple[FactoredNPB, int]:
    """Host build from the exact makea factors. Returns (containers, nnz_eff)
    where nnz_eff counts gathered elements per matvec (both passes)."""
    from lilac_tpu_torch.config import cfg
    from lilac_tpu_torch.formats.convert import (
        coo_to_csr_arrays,
        csr_to_seg_bucket_ell,
        csr_to_seg_ell_scan,
    )
    from lilac_tpu_torch.generate.npb import CLASSES, _generate_triples

    cls = CLASSES[class_name.upper()]
    n = cls.na
    conf = cfg()
    mode, vt_mode = _resolve_modes(conf, n, device)
    adj = vt_mode == "adj"

    def to_dev(v):
        return torch.as_tensor(to_vals(v, dtype), device=device)

    d0 = to_dev(np.asarray(cls.rcond - cls.shift))

    paths = meta_path = None
    if mode in ("routed", "mixed"):
        cache_dir = conf.resolved_data_dir()
        os.makedirs(cache_dir, exist_ok=True)
        # mixed's V is a hier plan at every n
        tag = plan_tag(conf, hier=mode == "mixed" or n > _rs.SINGLE_TABLE_MAX)
        # adj and mixed need, and write, V's file alone
        paths = [
            os.path.join(cache_dir, f"routed2_{cls.name}_{dtype}_{t}{tag}.npz")
            for t in (("V",) if adj or mode == "mixed" else ("V", "VT"))
        ]
        meta_path = os.path.join(
            cache_dir, f"routed2_{cls.name}_{dtype}_meta{tag}.npz"
        )
        if mode == "routed" and os.path.exists(meta_path):
            # full cache hit: the sidecar carries the already-permuted s
            # and nnz_eff, so the makea triples are not regenerated
            plans = _rs._load_plans(paths, device)
            try:
                with _PLAN_READ:
                    z = np.load(meta_path, allow_pickle=False)
                    s_meta, nnz_meta = z["s"], int(z["nnz_eff"])
            except _rs._LOAD_ERRORS:
                plans = None
            if plans is not None:
                V, VT = [maybe_pack_hier(p, device) for p in plans] + [None] * adj
                return FactoredNPB(V=V, VT=VT, s=to_dev(s_meta), d0=d0), nnz_meta

    with _PLAN_MAKEA:
        nzv_arr, ivc, vc = _generate_triples(cls)
    rows_i = np.repeat(np.arange(n, dtype=np.int64), nzv_arr)
    pos_j = ivc - 1

    sigma_i = None
    if mode in ("routed", "mixed"):
        # Run the whole solve in sigma-space: relabel the j (row/column)
        # space by descending V-column multiplicity so VT's rows are
        # already length-sorted and its per-matvec un-permute vanishes.
        # A' = P A P^T for a permutation P leaves every CG scalar (dots,
        # norms, zeta, rnorm) invariant, and the NPB main program feeds only
        # permutation-invariant vectors (x0 = ones).
        cnt_j = np.bincount(pos_j, minlength=n)
        sigma = np.argsort(-cnt_j, kind="stable")
        rank_s = np.empty(n, dtype=np.int64)
        rank_s[sigma] = np.arange(n)
        pos_j = rank_s[pos_j]
        # i-space relabel: order V's rows by descending length so V's
        # un-permute vanishes too. The i-space is internal to the factored
        # product (V' = P_i V P_j^T, VT' = V'^T, S' = P_i S P_i^T give the
        # same j-space similarity), so only s must be permuted to match.
        sigma_i = np.argsort(-nzv_arr, kind="stable")
        rank_i = np.empty(n, dtype=np.int64)
        rank_i[sigma_i] = np.arange(n)
        rows_i = rank_i[rows_i]
    v_ip, v_ix, v_v = coo_to_csr_arrays(rows_i, pos_j, vc, (n, n), sum_duplicates=False)
    t_ip, t_ix, t_v = coo_to_csr_arrays(pos_j, rows_i, vc, (n, n), sum_duplicates=False)

    if mode == "routed":
        # one plan a direction (V's alone for adj): a single table, or beyond
        # one table hierarchical networks. A plan whose file is there is
        # loaded, so going from adj to plan builds VT only. A hier plan is
        # built and saved on the host, then uploaded (packed) and its host
        # copy dropped before the next one is built.
        plans = []
        for path, (ip, ix, vv) in zip(
                paths, ((v_ip, v_ix, v_v), (t_ip, t_ix, t_v))):
            cached = _rs._load_plans([path], device)
            if cached is not None:
                plans.append(maybe_pack_hier(cached[0], device))
            elif n <= _rs.SINGLE_TABLE_MAX:
                with _PLAN_ROUTE(fence=device):
                    plans.append(build_routed_csr(
                        ip, ix, vv, (n, n), dtype=dtype, device=device))
                    save_routed(path, plans[-1])
            else:
                plans.append(_build_hier_plan(path, ip, ix, vv, n, dtype, device))
        V, VT = plans + [None] * adj
    elif mode == "mixed":
        # V routed (its hier plan file loaded, or built and saved), V^T a
        # gather layout: its rows are the sigma-sorted j space, already
        # length-sorted, as JagELLT needs
        cached = _rs._load_plans(paths, device)
        if cached is not None:
            V = maybe_pack_hier(cached[0], device)
        else:
            V = _build_hier_plan(paths[0], v_ip, v_ix, v_v, n, dtype, device)
        if dtype == "df64":
            from lilac_tpu_torch.formats.convert import csr_sorted_to_jag_ellt

            VT = csr_sorted_to_jag_ellt(t_ip, t_ix, to_vals(t_v, dtype), (n, n),
                                        device=device)
        else:
            VT = csr_to_seg_bucket_ell(t_ip, t_ix, to_vals(t_v, dtype), (n, n),
                                       seg_size=max(SEG_SIZE, n), device=device)
    elif mode == "scan":
        V, VT = (csr_to_seg_ell_scan(
            ip, ix, to_vals(vv, dtype), (n, n), seg_size=SEG_SIZE,
            seg_quantile=conf.seg_quantile, device=device)
            for ip, ix, vv in ((v_ip, v_ix, v_v), (t_ip, t_ix, t_v)))
    else:
        V = csr_to_seg_bucket_ell(
            v_ip, v_ix, to_vals(v_v, dtype), (n, n), seg_size=n, device=device
        )
        VT = csr_to_seg_bucket_ell(
            t_ip, t_ix, to_vals(t_v, dtype), (n, n), seg_size=n, device=device
        )

    ratio = cls.rcond ** (1.0 / n)
    s = np.empty(n, dtype=np.float64)
    s[0] = 1.0
    np.multiply.accumulate(np.full(n - 1, ratio), out=s[1:])
    if sigma_i is not None:
        s = s[sigma_i]  # S' = P_i S P_i^T

    nnz_eff = int(nzv_arr.sum()) * 2
    if mode == "routed":
        np.savez(meta_path, s=s, nnz_eff=np.int64(nnz_eff))
    return FactoredNPB(V=V, VT=VT, s=to_dev(s), d0=d0), nnz_eff


# ---------------------------------------------------------------------------
# matvec implementations
# ---------------------------------------------------------------------------


def _spmv_any(A, x):
    if isinstance(A, RoutedMat):
        return routed_spmv(A, x)
    if isinstance(A, RoutedMatHierP):
        return routed_hier_spmv(A, x)
    if isinstance(A, RoutedMatSeg):
        return routed_seg_spmv(A, x)
    if isinstance(A, SegELLScan):
        return seg_ell_scan_spmv(A, x)
    return seg_bucket_ell_spmv(A, x)


def _spmv_any_df(A, x):
    if isinstance(A, JagELLT):
        return jag_ellt_spmv_df(A, x)
    if isinstance(A, RoutedMat):
        return routed_spmv_df(A, x)
    if isinstance(A, RoutedMatHierP):
        return routed_hier_spmv_df(A, x)
    if isinstance(A, RoutedMatSeg):
        return routed_seg_spmv_df(A, x)
    if isinstance(A, SegELLScan):
        return seg_ell_scan_spmv_df(A, x)
    return seg_bucket_ell_spmv_df(A, x)


def _spmv_adj_any(A, u):
    """V^T u through V's OWN routed plan run in reverse: used when
    FactoredNPB.VT is None (factored_vt=adj)."""
    if isinstance(A, RoutedMat):
        return routed_spmv_adj_t(A, u)
    if isinstance(A, RoutedMatHierP):
        return routed_hier_spmv_adj_t(A, u)
    raise TypeError(f"no VT and V is a {type(A).__name__}, not a routed plan")


def _spmv_adj_any_df(A, u):
    if isinstance(A, RoutedMat):
        return routed_spmv_adj_t_df(A, u)
    if isinstance(A, RoutedMatHierP):
        return routed_hier_spmv_adj_t_df(A, u)
    raise TypeError(f"no VT and V is a {type(A).__name__}, not a routed plan")


def factored_spmv(A: FactoredNPB, x: torch.Tensor) -> torch.Tensor:
    """Plain-float factored product (f32/f64)."""
    with _MATVEC:
        with _V:
            t = _spmv_any(A.V, x)
        u = A.s * t
        with _VT:
            y = _spmv_adj_any(A.V, u) if A.VT is None else _spmv_any(A.VT, u)
        return y + A.d0 * x


def factored_spmv_df(A: FactoredNPB, x: df.DF) -> df.DF:
    """df64 factored product: TwoProd per element, compensated reductions."""
    with _MATVEC:
        with _V:
            t = _spmv_any_df(A.V, x)
        s = df.DF(A.s[..., 0], A.s[..., 1])
        u = df.mul(s, t)
        with _VT:
            y = _spmv_adj_any_df(A.V, u) if A.VT is None else _spmv_any_df(A.VT, u)
        d0 = df.DF(A.d0[..., 0], A.d0[..., 1])
        return df.add(y, df.mul(d0, x))
