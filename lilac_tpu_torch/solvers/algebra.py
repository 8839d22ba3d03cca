"""Vector-algebra adapters so solvers are generic over the value dtype.

Counterpart of lilac_tpu/solvers/algebra.py: one CG implementation
serves plain float (f32/f64) and double-word f32 (df64) values.
"""

from __future__ import annotations

import numpy as np
import torch

from lilac_tpu_torch.ops import dfloat as df
from lilac_tpu_torch.utils.profiling import span

# the solver's own vector algebra, a span a method
_DOT = span("lilac.solver.dot")
_ADD = span("lilac.solver.add")
_SUB = span("lilac.solver.sub")
_SMUL = span("lilac.solver.smul")
_SDIV = span("lilac.solver.sdiv")
_SSQRT = span("lilac.solver.ssqrt")


class FloatAlg:
    """Plain torch arithmetic in a fixed dtype."""

    def __init__(self, dtype=torch.float32, device="cuda"):
        self.dtype = dtype
        self.device = device

    def dot(self, u, v):
        # multiply + reduce-sum, as the reference does: the two packages
        # then round at the same places up to the order of the sum
        with _DOT:
            return (u * v).sum()

    def add(self, u, v):
        with _ADD:
            return u + v

    def sub(self, u, v):
        with _SUB:
            return u - v

    def smul(self, s, u):  # scalar * vector (or scalar * scalar)
        with _SMUL:
            return s * u

    def sdiv(self, a, b):  # scalar / scalar
        with _SDIV:
            return a / b

    def ssqrt(self, a):
        with _SSQRT:
            return torch.sqrt(a)

    def scalar(self, v):
        return torch.tensor(float(v), dtype=self.dtype, device=self.device)

    def zeros_like(self, u):
        return torch.zeros_like(u)

    def stack(self, scalars):
        return torch.stack(list(scalars))

    def to_f64(self, s):
        return s.detach().cpu().numpy().astype(np.float64)


class DF64Alg:
    """Double-word f32 arithmetic (see lilac_tpu_torch.ops.dfloat)."""

    dtype = "df64"

    def __init__(self, device="cuda"):
        self.device = device

    def dot(self, u, v):
        with _DOT:
            return df.dot(u, v)

    def add(self, u, v):
        with _ADD:
            return df.add(u, v)

    def sub(self, u, v):
        with _SUB:
            return df.sub(u, v)

    def smul(self, s, u):
        # scalar DF times vector DF: 0-dim tensors broadcast through mul
        with _SMUL:
            return df.mul(s, u)

    def sdiv(self, a, b):
        with _SDIV:
            return df.div(a, b)

    def ssqrt(self, a):
        with _SSQRT:
            return df.sqrt(a)

    def scalar(self, v):
        return df.full((), float(v), device=self.device)

    def zeros_like(self, u):
        return df.DF(torch.zeros_like(u.hi), torch.zeros_like(u.lo))

    def stack(self, scalars):
        scalars = list(scalars)
        return df.DF(torch.stack([s.hi for s in scalars]),
                     torch.stack([s.lo for s in scalars]))

    def to_f64(self, s):
        return df.to_f64(s)


def get_algebra(dtype: str, device="cuda"):
    if dtype == "df64":
        return DF64Alg(device)
    m = {"f32": torch.float32, "f64": torch.float64}
    return FloatAlg(m[dtype], device)
