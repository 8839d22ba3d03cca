"""The df64 dot product in two launches (csrc/dfdot.cu).

`dfdot(u, v)` returns `ops.dfloat.dot(u, v)` bit for bit: df.mul of the
terms, then sum_df's pairwise halving tree, whose level k + 1 holds
add(L_k[i], L_k[i + n_{k+1}]) (the df zero past the end) with level sizes
n_{k+1} = ceil(n_k / 2). The first launch has thread i < n_K compute L_K[i]
from its 2^K terms alone; the second, one thread block, takes the n_K
values on to one. The library chooses K from n and the card's SM count
(`kernel_depth`); this module allocates the n_K pairs of scratch and
launches. Eagerly the chain is one launch an EFT step of every
level, about 400 launches a dot at NPB class C; here it is two, and the
host no longer sets the dot's pace.

`dfdot_plain(a, b, K)` is the same schedule in eager f32 ops (each
thread's subtree, vectorised over the threads, then df.sum_df on the n_K
values): what the tests hold against df.dot and the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from lilac_tpu_torch.kernels import _cuda
from lilac_tpu_torch.ops import dfloat as df


def level_size(n: int, k: int) -> int:
    """ceil(n / 2^k): the values at level k of the halving tree over n."""
    return -(-n >> k)


def _check(u: df.DF, v: df.DF) -> int:
    planes = (u.hi, u.lo, v.hi, v.lo)
    n = u.hi.shape[0] if u.hi.dim() == 1 else -1
    for t in planes:
        if (t.dtype != torch.float32 or t.dim() != 1 or t.shape[0] != n
                or t.device != u.hi.device):
            raise ValueError(
                "dfdot takes four float32 1-D planes of one length on one "
                f"device, got {[(str(p.dtype), tuple(p.shape), str(p.device)) for p in planes]}")
    if n < 1:
        raise ValueError("dfdot takes planes of at least one term")
    if not u.hi.is_cuda:
        raise ValueError(f"dfdot takes CUDA planes, got {u.hi.device}: "
                         "the op chain df.dot is the dot elsewhere")
    return n


def dfdot_plain(a: df.DF, b: df.DF, K: int) -> df.DF:
    """The kernel's schedule in eager ops: thread i < n_K walks the 2^K
    leaves of L_K[i] in the tree's order (leaf t at i plus n_k for each
    set bit k - 1 of t, the df zero where the path takes a pad), merging
    them on a stack; then df.sum_df over the n_K values."""
    n = a.hi.shape[0]
    m = level_size(n, K)
    i = torch.arange(m, device=a.hi.device)
    zero = torch.zeros(m, dtype=torch.float32, device=a.hi.device)
    stack = []
    for t in range(1 << K):
        j, ok = i, torch.ones(m, dtype=torch.bool, device=a.hi.device)
        for k in range(K, 0, -1):
            if (t >> (k - 1)) & 1:
                j = j + level_size(n, k)
                ok = ok & (j < level_size(n, k - 1))
        j = torch.where(ok, j, 0)
        p = df.mul(df.DF(a.hi[j], a.lo[j]), df.DF(b.hi[j], b.lo[j]))
        val = df.DF(torch.where(ok, p.hi, zero), torch.where(ok, p.lo, zero))
        k = 0
        while (t >> k) & 1:
            val = df.add(stack.pop(), val)
            k += 1
        stack.append(val)
    return df.sum_df(stack[-1])


def _lib():
    lib = _cuda.load("dfdot")
    if not getattr(lib, "_typed", False):
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.lilac_dfdot_depth.argtypes = [ll, i]
        lib.lilac_dfdot_depth.restype = i
        lib.lilac_dfdot.argtypes = [vp, vp, vp, vp, ll, i, vp, vp, vp]
        lib.lilac_dfdot.restype = i
        lib._typed = True
    return lib


@functools.lru_cache(maxsize=None)
def device_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def kernel_depth(n: int, sms: int) -> int:
    """The K of the first launch on n terms and a card of sms SMs, as
    csrc/dfdot.cu chooses it (lilac_dfdot_depth): 5 at NPB classes C and D
    on an H100."""
    depth = _lib().lilac_dfdot_depth(n, sms)
    if depth < 0:
        raise ValueError(f"dfdot takes 1 to 2^32 terms, got {n}")
    return depth


def dfdot(u: df.DF, v: df.DF) -> df.DF:
    """df.dot(u, v) of two n-long df vectors on a CUDA card as a pair of
    0-dim tensors, bit for bit, through the kernel on the current stream
    (planes made contiguous first where they are not), with nothing read
    back to the host."""
    n = _check(u, v)
    dev = u.hi.device
    sms = device_sms(dev.index)
    depth = kernel_depth(n, sms)
    planes = [t.contiguous() for t in (u.hi, u.lo, v.hi, v.lo)]
    out = torch.empty(2, dtype=torch.float32, device=dev)
    part = (torch.empty(2 * level_size(n, depth), dtype=torch.float32, device=dev)
            if depth else None)
    err = _cuda.launch_on(dev.index, lambda stream: _lib().lilac_dfdot(
        *(t.data_ptr() for t in planes), n, sms,
        None if part is None else part.data_ptr(), out.data_ptr(), stream))
    _cuda.check(err, "dfdot")
    dfdot.launches += 2 if depth else 1
    hi, lo = out.unbind()
    return df.DF(hi, lo)


dfdot.launches = 0  # kernel launches by dfdot
