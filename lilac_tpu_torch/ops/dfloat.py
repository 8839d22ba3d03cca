"""Double-word float32 ("df64") arithmetic on torch tensors.

Counterpart of lilac_tpu/ops/dfloat.py. A value is (hi, lo) with
value = hi + lo and |lo| <= ulp(hi)/2, giving ~2^-48 relative precision,
built from error-free transformations (Dekker/Knuth).

Every EFT intermediate must be the exactly-rounded f32 result. Eager
PyTorch runs each arithmetic op as its own kernel, so nothing contracts
`a*b +/- c` into an FMA and nothing cancels `s - a` after `s = a + b`:
the barriers of the JAX module are not needed here. That holds only in
eager mode; torch.compile would fuse these chains and void the
identities, so nothing in this package compiles them.

A DF is a plain (hi, lo) tuple of equal-shaped f32 tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F


class DF(NamedTuple):
    hi: torch.Tensor
    lo: torch.Tensor

    @property
    def shape(self):
        return self.hi.shape

    @property
    def dtype(self):
        return self.hi.dtype

    @property
    def device(self):
        return self.hi.device


_SPLIT = 4097.0  # 2^12 + 1 for f32 (24-bit mantissa -> 12+12 split)


def _two_sum(a, b):
    """Knuth TwoSum: s + e == a + b exactly."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _quick_two_sum(a, b):
    """Fast TwoSum, requires |a| >= |b|."""
    s = a + b
    e = b - (s - a)
    return s, e


def _split(a):
    t = _SPLIT * a
    ahi = t - (t - a)
    alo = a - ahi
    return ahi, alo


def _two_prod(a, b):
    """Dekker TwoProd: p + e == a * b exactly (no FMA dependence)."""
    p = a * b
    ahi, alo = _split(a)
    bhi, blo = _split(b)
    e = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, e


# ---------------------------------------------------------------------------
# construction / conversion
# ---------------------------------------------------------------------------


def split_f64_np(x: np.ndarray) -> np.ndarray:
    """Host-side double-word split: f64 array -> [..., 2] (hi, lo) f32.

    The one place that owns the rounding convention every plan constructor uses
    when staging df64 values (hi = round-to-f32, lo = exact residual)."""
    x = np.asarray(x, dtype=np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return np.stack([hi, lo], axis=-1)


def from_f64(x, device="cuda") -> DF:
    """Split host float64 data into an exact (hi, lo) f32 pair (on host)."""
    s = split_f64_np(x)
    return DF(
        torch.as_tensor(np.ascontiguousarray(s[..., 0]), device=device),
        torch.as_tensor(np.ascontiguousarray(s[..., 1]), device=device),
    )


def from_f32(x) -> DF:
    x = x.to(torch.float32)
    return DF(x, torch.zeros_like(x))


def to_f64(d: DF) -> np.ndarray:
    hi = d.hi.detach().cpu().numpy().astype(np.float64)
    lo = d.lo.detach().cpu().numpy().astype(np.float64)
    return hi + lo


def zeros(shape, device="cuda") -> DF:
    z = torch.zeros(shape, dtype=torch.float32, device=device)
    return DF(z, z.clone())


def full(shape, value: float, device="cuda") -> DF:
    v = np.float64(value)
    hi = np.float32(v)
    lo = np.float32(v - np.float64(hi))
    return DF(
        torch.full(shape, float(hi), dtype=torch.float32, device=device),
        torch.full(shape, float(lo), dtype=torch.float32, device=device),
    )


# ---------------------------------------------------------------------------
# arithmetic
# ---------------------------------------------------------------------------


def add(a: DF, b: DF) -> DF:
    """Accurate (QD 'ieee') double-word addition: keeps ~2^-48 relative
    error even when the hi components cancel, which CG residual updates
    do all the time."""
    s1, s2 = _two_sum(a.hi, b.hi)
    t1, t2 = _two_sum(a.lo, b.lo)
    s2 = s2 + t1
    s1, s2 = _quick_two_sum(s1, s2)
    s2 = s2 + t2
    hi, lo = _quick_two_sum(s1, s2)
    return DF(hi, lo)


def neg(a: DF) -> DF:
    return DF(-a.hi, -a.lo)


def sub(a: DF, b: DF) -> DF:
    return add(a, neg(b))


def mul(a: DF, b: DF) -> DF:
    p, e = _two_prod(a.hi, b.hi)
    e = e + (a.hi * b.lo + a.lo * b.hi)
    hi, lo = _quick_two_sum(p, e)
    return DF(hi, lo)


def mul_f32(a: DF, b) -> DF:
    p, e = _two_prod(a.hi, b)
    e = e + a.lo * b
    hi, lo = _quick_two_sum(p, e)
    return DF(hi, lo)


def div(a: DF, b: DF) -> DF:
    q1 = a.hi / b.hi
    r = sub(a, mul_f32(b, q1))
    q2 = r.hi / b.hi
    r = sub(r, mul_f32(b, q2))
    q3 = r.hi / b.hi
    hi, lo = _quick_two_sum(q1, q2)
    return add(DF(hi, lo), from_f32(q3))


def sqrt(a: DF) -> DF:
    s = torch.sqrt(a.hi)
    # one Newton step in df: s' = s + (a - s^2) / (2 s)
    s_df = from_f32(s)
    diff = sub(a, mul(s_df, s_df))
    corr = diff.hi / (2.0 * s)
    return add(s_df, from_f32(corr))


def rsqrt(a: DF) -> DF:
    return div(full((), 1.0, device=a.hi.device), sqrt(a))


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------


def sum_df(a: DF, axis: int = -1) -> DF:
    """Accurate reduction along an axis by pairwise df-addition halving
    (the same tree as the JAX module: O(log n) df-add steps)."""
    hi = torch.movedim(a.hi, axis, -1)
    lo = torch.movedim(a.lo, axis, -1)
    n = hi.shape[-1]
    while n > 1:
        half = (n + 1) // 2
        pad = half * 2 - n
        if pad:
            hi = F.pad(hi, (0, pad))
            lo = F.pad(lo, (0, pad))
        r = add(DF(hi[..., :half], lo[..., :half]),
                DF(hi[..., half:], lo[..., half:]))
        hi, lo = r.hi, r.lo
        n = half
    return DF(hi[..., 0], lo[..., 0])


def sum_df0(a: DF) -> DF:
    """sum_df(a, axis=0) without the movedim: a (K, rows) array reduced
    over its major axis keeps every intermediate rows-minor (contiguous
    halves, no strided copies)."""
    hi, lo = a.hi, a.lo
    k = hi.shape[0]
    while k > 1:
        half = (k + 1) // 2
        pad = half * 2 - k
        if pad:
            z = hi.new_zeros((pad,) + tuple(hi.shape[1:]))
            hi = torch.cat([hi, z])
            lo = torch.cat([lo, z])
        r = add(DF(hi[:half], lo[:half]), DF(hi[half:], lo[half:]))
        hi, lo = r.hi, r.lo
        k = half
    return DF(hi[0], lo[0])


def dot(a: DF, b: DF) -> DF:
    """Accurate dot product of two df vectors (TwoProd + pairwise df-sum)."""
    return sum_df(mul(a, b), axis=-1)
