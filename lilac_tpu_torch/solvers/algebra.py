"""Vector-algebra adapters so solvers are generic over the value dtype.

Counterpart of lilac_tpu/solvers/algebra.py: one CG implementation
serves plain float (f32/f64) and double-word f32 (df64) values.
"""

from __future__ import annotations

import numpy as np
import torch

from lilac_tpu_torch.kernels import dfops
from lilac_tpu_torch.kernels.dfdot import dfdot
from lilac_tpu_torch.ops import dfloat as df
from lilac_tpu_torch.utils.profiling import span

# the solver's own vector algebra, a span a method
_DOT = span("lilac.solver.dot")
_DOT_FUSED = span("lilac.solver.dot.fused")  # a dot through kernels/dfdot.py
_ADD = span("lilac.solver.add")
_SUB = span("lilac.solver.sub")
_SMUL = span("lilac.solver.smul")
_SDIV = span("lilac.solver.sdiv")
_SSQRT = span("lilac.solver.ssqrt")
# a call that DF64Alg hands to kernels/dfops.py, one a method
_ADD_FUSED = span("lilac.solver.add.fused")
_SUB_FUSED = span("lilac.solver.sub.fused")
_SMUL_FUSED = span("lilac.solver.smul.fused")
_SDIV_FUSED = span("lilac.solver.sdiv.fused")
_SSQRT_FUSED = span("lilac.solver.ssqrt.fused")


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


def _guarded_div(a, b):
    """df.div, but a zero numerator gives that zero, not 0/0 = NaN: a df64
    word keeps f32's exponent range, so a converged CG's rho (r.r)
    underflows to 0 and beta = rho_new / rho would be 0/0 (NPB class C,
    from some start vectors, after a few dozen outer steps). Any other
    quotient is df.div's, bit for bit. The JAX package's df.div gives the
    NaN: here the port parts from it on purpose. dfops.div has the guard."""
    q = df.div(a, b)
    zero = a.hi == 0
    return df.DF(torch.where(zero, a.hi, q.hi), torch.where(zero, a.hi, q.lo))


def _fused(fused_span, entry, chain, *operands):
    """kernels/dfops.py's `entry` in fused_span where it takes the operands,
    else chain(*operands): the same bits either way."""
    shape = dfops.result_shape(*operands)
    if shape is None:
        return chain(*operands)
    with fused_span:
        return dfops._launch(entry, operands, shape)


class DF64Alg:
    """Double-word f32 arithmetic (see lilac_tpu_torch.ops.dfloat)."""

    dtype = "df64"

    def __init__(self, device="cuda"):
        self.device = device

    def dot(self, u, v):
        # CUDA vectors take the two-launch kernel, df.dot's bits; CPU
        # vectors the op chain itself
        with _DOT:
            if u.hi.is_cuda:
                with _DOT_FUSED:
                    return dfdot(u, v)
            return df.dot(u, v)

    # The other methods: where kernels/dfops.py takes the operands (float32
    # CUDA planes, 1-D of one length or 0-dim) one launch of the chain's
    # bits; elsewhere the op chain itself.

    def add(self, u, v):
        with _ADD:
            return _fused(_ADD_FUSED, "add", df.add, u, v)

    def sub(self, u, v):
        with _SUB:
            return _fused(_SUB_FUSED, "sub", df.sub, u, v)

    def smul(self, s, u):
        # scalar DF times vector DF: 0-dim tensors broadcast through mul
        with _SMUL:
            return _fused(_SMUL_FUSED, "mul", df.mul, s, u)

    def sdiv(self, a, b):
        with _SDIV:
            return _fused(_SDIV_FUSED, "div", _guarded_div, a, b)

    def ssqrt(self, a):
        with _SSQRT:
            return _fused(_SSQRT_FUSED, "sqrt", df.sqrt, a)

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
