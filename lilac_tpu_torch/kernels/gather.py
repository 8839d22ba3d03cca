"""Gather SpMV on torch index ops: the port's independent plain operator.

Counterpart of the SegBucketELL kernels of lilac_tpu/kernels/xla.py
(`pair_gather`, `seg_bucket_ell_spmv`, `seg_bucket_ell_spmv_df`). What
the JAX package left to XLA's gather is plain torch indexing here; no
hand kernel is involved, which makes this path the check on the routed
one (factored segmode "single").
"""

from __future__ import annotations

import torch

from lilac_tpu_torch.formats.sparse import SegBucketELL
from lilac_tpu_torch.ops import dfloat as df


def pair_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx]. (The reference gathers [*, 2] rows to reach a faster XLA
    emitter; torch's index kernel needs no such shaping.)"""
    return x[idx]


def seg_bucket_ell_spmv(A: SegBucketELL, x: torch.Tensor) -> torch.Tensor:
    acc = {}
    for (lo, hi, _s, _w), v, i in zip(A.parts, A.data, A.indices):
        part = (v * x[i]).sum(dim=1)
        prev = acc.get((lo, hi))
        acc[(lo, hi)] = part if prev is None else prev + part
    y = torch.cat([acc[k] for k in sorted(acc)])
    if A.identity_perm:
        return y
    return pair_gather(y, A.inv_perm)


def seg_bucket_ell_spmv_df(A: SegBucketELL, x: df.DF) -> df.DF:
    acc = {}
    for (lo, hi, _s, _w), v, i in zip(A.parts, A.data, A.indices):
        a = df.DF(v[..., 0], v[..., 1])
        t = df.sum_df(df.mul(a, df.DF(x.hi[i], x.lo[i])), axis=1)
        prev = acc.get((lo, hi))
        acc[(lo, hi)] = t if prev is None else df.add(prev, t)
    his = torch.cat([acc[k].hi for k in sorted(acc)])
    los = torch.cat([acc[k].lo for k in sorted(acc)])
    if A.identity_perm:
        return df.DF(his, los)
    return df.DF(his[A.inv_perm], los[A.inv_perm])
