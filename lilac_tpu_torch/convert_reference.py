"""The JAX package's containers, handed over as numpy arrays and Python
tuples, rebuilt as the port's containers.

With these both packages compute on the same plan: a test (or a migration
script) calls ``np.asarray`` on each field of the JAX container and passes
the arrays here. This module imports neither package's JAX side.
"""

from __future__ import annotations

import numpy as np
import torch

from lilac_tpu_torch.formats.sparse import BSR, COO, CSR, ELL, BucketELL, SegBucketELL
from lilac_tpu_torch.kernels.factored import FactoredNPB
from lilac_tpu_torch.kernels.routed_spmv import (
    HierNet,
    RoutedMat,
    RoutedMatHier,
    hier_to_device,
    pack_hier,
)
from lilac_tpu_torch.ops.dfloat import DF


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
    m, m_out, bl, n_nz, colmajor, device="cuda", pack=True,
):
    """A hierarchical plan from its per-net arrays, put on `device`.

    nets_masks[i][j]: net i's pass j mask array (int8, the plan file's
    layout); nets_meta[i]: its static pass descriptors; vals[i]: [m] or
    [m, 2]; unperm_masks / unperm_meta: the un-permute network or None;
    chunks[i] = ((slot0, rows_c, K), ...). pack: True = RoutedMatHierP
    (pack_hier), False = RoutedMatHier net by net."""
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
    return pack_hier(M, device) if pack else hier_to_device(M, device)


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
