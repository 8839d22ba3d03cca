"""The df64 vector algebra of the solvers at one launch a call (csrc/dfops.cu).

`add`, `sub`, `mul`, `div` and `sqrt` return ops/dfloat.py's add, sub,
mul, div and sqrt bit for bit, `div` with DF64Alg.sdiv's guard (a zero
numerator gives that zero): the kernel runs the chain's EFT steps in the
chain's order on each element. Eagerly each chain is one launch an EFT
step, 20 to 118 launches a call; here it is one, and the host no longer
sets the pace of the solver's vector updates and scalar divides.

The kernels take float32 CUDA planes on one device: two equal 1-D
operands, a 0-dim df scalar with a 1-D vector (broadcast, as torch does),
or two 0-dim scalars. `result_shape` alone decides whether they take the
operands; each entry asks it, and DF64Alg asks it once and then calls
`_launch` with its answer. Planes are made contiguous first where they
are not; outputs are new tensors. The eager chain is the plain version,
as df.dot is dfdot's.
"""

from __future__ import annotations

import ctypes

import torch

from lilac_tpu_torch.kernels import _cuda
from lilac_tpu_torch.kernels.dfdot import device_sms
from lilac_tpu_torch.ops import dfloat as df

# csrc/dfops.cu's Op, by entry
_OPS = {"add": 0, "sub": 1, "mul": 2, "div": 3, "sqrt": 4}


def _shape(*planes: torch.Tensor):
    """The result's shape where the planes are float32, on one device, and
    each 0-dim or 1-D with every 1-D plane of one nonzero length; else
    None. A df operand's two planes are given in turn."""
    dev = planes[0].device
    n = None
    for t in planes:
        if t.dtype != torch.float32 or t.device != dev:
            return None
        d = t.dim()
        if d == 1:
            if n is None:
                n = t.shape[0]
            elif t.shape[0] != n:
                return None
        elif d != 0:
            return None
    if n == 0:
        return None
    for i in range(0, len(planes), 2):  # hi and lo of an operand agree
        if planes[i].dim() != planes[i + 1].dim():
            return None
    return () if n is None else (n,)


def result_shape(*operands: df.DF):
    """The shape of the result where the kernels take these df operands
    (() for 0-dim scalars), None where they do not: off a CUDA card the op
    chain is the arithmetic."""
    planes = [t for d in operands for t in d]
    if not planes[0].is_cuda:
        return None
    return _shape(*planes)


def _lib():
    lib = _cuda.load("dfops")
    if not getattr(lib, "_typed", False):
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.lilac_dfops.argtypes = [i, vp, vp, ll, vp, vp, ll, vp, vp, ll, i, vp]
        lib.lilac_dfops.restype = i
        lib._typed = True
    return lib


def _launch(name: str, operands, shape) -> df.DF:
    """The kernel of entry `name` on operands whose result_shape is
    `shape`, which the caller has just had from it."""
    planes = [t for d in operands for t in d]
    dev = planes[0].device
    ah, al, bh, bl = [t.contiguous() for t in planes * (4 // len(planes))]
    if shape:
        hi = torch.empty(shape, dtype=torch.float32, device=dev)
        lo = torch.empty(shape, dtype=torch.float32, device=dev)
    else:
        hi, lo = torch.empty(2, dtype=torch.float32, device=dev).unbind()
    err = _cuda.launch_on(dev.index, lambda stream: _lib().lilac_dfops(
        _OPS[name], ah.data_ptr(), al.data_ptr(), min(ah.dim(), 1),
        bh.data_ptr(), bl.data_ptr(), min(bh.dim(), 1),
        hi.data_ptr(), lo.data_ptr(), shape[0] if shape else 1,
        device_sms(dev.index), stream))
    _cuda.check(err, f"dfops.{name}")
    launches[name] += 1
    return df.DF(hi, lo)


def _entry(name: str, *operands: df.DF) -> df.DF:
    shape = result_shape(*operands)
    if shape is None:
        planes = [t for d in operands for t in d]
        raise ValueError(
            f"dfops.{name} takes float32 CUDA planes on one device, 1-D of one "
            "length or 0-dim, got "
            f"{[(str(p.dtype), tuple(p.shape), str(p.device)) for p in planes]}")
    return _launch(name, operands, shape)


def add(a: df.DF, b: df.DF) -> df.DF:
    """df.add(a, b) in one launch."""
    return _entry("add", a, b)


def sub(a: df.DF, b: df.DF) -> df.DF:
    """df.sub(a, b) in one launch."""
    return _entry("sub", a, b)


def mul(a: df.DF, b: df.DF) -> df.DF:
    """df.mul(a, b) in one launch (DF64Alg.smul: a 0-dim a over a vector b)."""
    return _entry("mul", a, b)


def div(a: df.DF, b: df.DF) -> df.DF:
    """df.div(a, b) in one launch, (a.hi, a.hi) where a.hi == 0: DF64Alg.sdiv."""
    return _entry("div", a, b)


def sqrt(a: df.DF) -> df.DF:
    """df.sqrt(a) in one launch."""
    return _entry("sqrt", a)


# kernel launches by entry
launches = {"add": 0, "sub": 0, "mul": 0, "div": 0, "sqrt": 0}
