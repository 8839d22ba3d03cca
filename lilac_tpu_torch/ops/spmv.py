"""Functional sparse ops: the uniform `spmv(A, x)` surface.

Counterpart of lilac_tpu/ops/spmv.py: `spmv` / `spmv_t` dispatch on the
container type to the gather kernels (kernels/gather.py), `spmm` applies
`spmv` to each column of a dense block. Workloads call these directly or
build an SpmvPlan (lilac_tpu_torch.plan) for kernel selection and value
policies.
"""

from __future__ import annotations

import torch

from lilac_tpu_torch.formats.sparse import BSR, COO, CSR, ELL, BucketELL
from lilac_tpu_torch.kernels import gather


def spmv(A, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x; the value dtype follows the container."""
    if isinstance(A, CSR):
        return gather.csr_spmv(A, x)
    if isinstance(A, ELL):
        return gather.ell_spmv(A, x)
    if isinstance(A, COO):
        return gather.coo_spmv(A, x)
    if isinstance(A, BSR):
        return gather.bsr_spmv(A, x)
    if isinstance(A, BucketELL):
        return gather.bucket_ell_spmv(A, x)
    raise TypeError(f"unsupported container {type(A)}")


def spmv_t(A, x: torch.Tensor) -> torch.Tensor:
    """y = A.T @ x (the true transpose product)."""
    if isinstance(A, CSR):
        return gather.csr_spmv_t(A, x)
    if isinstance(A, ELL):
        return gather.ell_spmv_t(A, x)
    if isinstance(A, COO):
        return gather.coo_spmv_t(A, x)
    raise TypeError(f"unsupported container {type(A)}")


def spmm(A, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for a dense [n, k] block of right-hand sides, one spmv per
    column."""
    return torch.stack([spmv(A, X[:, j]) for j in range(X.shape[1])], dim=1)
