"""Named kernel registry.

Counterpart of lilac_tpu/kernels/registry.py. Each kernel is
`fn(A, x) -> y` for one container type; an entry records the container
class, whether it takes double-word (hi, lo) values, and its Aᵀx form
where it has one, so that SpmvPlan can pick by name. The names are the
JAX package's, so an `--impl` value and the `impl` column of a bench CSV
mean the same kernel on both platforms.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional


@dataclasses.dataclass(frozen=True)
class KernelEntry:
    name: str
    fn: Callable
    container: type
    dfloat: bool = False  # operates on (hi, lo) double-word values
    transpose: Optional[Callable] = None  # optional A^T x implementation


KERNELS: Dict[str, KernelEntry] = {}


def register_kernel(name, fn, container, dfloat=False, transpose=None):
    KERNELS[name] = KernelEntry(name, fn, container, dfloat, transpose)
    return fn


def get_kernel(name: str) -> KernelEntry:
    if name not in KERNELS:
        raise KeyError(f"unknown kernel {name!r}; have {sorted(KERNELS)}")
    return KERNELS[name]
