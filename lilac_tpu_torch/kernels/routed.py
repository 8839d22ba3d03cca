"""Device applier for plan-time gather routing networks.

Counterpart of lilac_tpu/kernels/routed.py: the single-table network
forward (`routed_apply`, kernel K1, and `masks_device`) and adjoint
(`routed_apply_t`, K11); the hierarchical networks forward (`compile_hier`,
the four pass appliers K3-K6 with their un-batched twins, `hier_apply`,
`hier_apply_batched`) and adjoint (the four `*_bt` appliers K7-K10 and
`hier_apply_batched_t`).

Stage primitive (same semantics as routenet.GatherPlanHost.apply_host):
    xor    d: y[i] <- mask[i] ? y[i ^ d] : y[i]
    shift  d: y[i] <- mask[i] ? y[i - d] : y[i]   (cyclic over the flat m)
    shiftl d: y[i] <- mask[i] ? y[i + d] : y[i]   (cyclic over the flat m)

The adjoint of a stage (the transpose Gᵀ of the gather G it encodes) is the
stage itself for xor, an exchange, and for shift / shiftl the add-merge
    u'[i] = (mask[i] ? 0 : u[i]) + (mask[j] ? u[j] : 0),
j = i + d for shift and i - d for shiftl (`_stage_adj_plain`); a network's
adjoint runs its stages in reverse order. With `dfpair` two planes are one
df64 (hi, lo) pair and every merge is a compensated TwoSum add.

`routed_apply` launches the CUDA kernel of csrc/routed.cu for tensors on
the card and takes `routed_apply_plain` only for tensors that lie on the
CPU. Both only move values, so they agree bit for bit. The same holds for
each hierarchical applier and its `*_plain` version (csrc/hier.cu), and for
the adjoint appliers (csrc/hier.cu, csrc/adjoint.cu), whose sums are taken
in the same order with every step rounded on its own.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
from collections import Counter
from typing import Sequence, Tuple

import numpy as np
import torch

from lilac_tpu_torch.kernels import _cuda

_KIND_CODE = {"xor": 0, "shift": 1, "shiftl": 2}
_WORD_DTYPES = (torch.float32, torch.float64)
_MAX_NETS = 65535  # grid.y of the stage kernel


def check_table_feasible(m: int, nets: int = 1, *, what: str = "") -> None:
    """Raise at plan-build time when the single-table kernel cannot take a
    network of m slots.

    The kernels (K1, K11) run a network as a few passes over tiles of T
    slots held in shared memory (routed_passes). What bounds the tile is
    the card's opt-in shared memory: T is chosen from it for the word width
    and plane count (routed_tile), so it never makes a plan infeasible.
    Nothing on chip bounds m: the table itself lives in device memory, and
    a table of more than T^2/4 slots runs its stages with d >= T one grid
    each. The limits are the slot layout (a power of two, a multiple of
    1024, which the [R, 128] mask planes need), the grid's second dimension
    (nets <= 65535) and device memory itself. Indices are 64-bit."""
    if m < 1024 or m & (m - 1) or m % 1024:
        raise ValueError(
            f"routed plan {what or 'config'}: table size m={m} must be a "
            "power of two and a multiple of 1024"
        )
    if not 1 <= nets <= _MAX_NETS:
        raise ValueError(
            f"routed plan {what or 'config'}: {nets} nets in one call "
            f"(limit {_MAX_NETS})"
        )


# ---- pass schedule of the single-table kernels (K1, K11) ------------------
#
# A pass is one grid of csrc/tile_pass.cuh: (kind, first stage, end stage).
#   low   stages with d < T on a contiguous tile: xor stages only, or shift /
#         shiftl stages only whose halos (sum(d) of each direction, rounded
#         up to 4 slots) add up to at most T
#   high  stages with d a multiple of T, where T < m <= T^2/4: a tile holds
#         every high address bit for 4 or more consecutive low slots, so
#         xor and cyclic shifts stay inside it
#   stage one stage with d >= T where m > T^2/4: a grid over the whole table
# A pass with a halo holds at most 16 stages (3 mask planes a slot), any
# other tile pass 32 (5 planes).

PASS_KINDS = ("low", "high", "stage")
_PASS_CODE = {k: i for i, k in enumerate(PASS_KINDS)}
MAX_PASS_STAGES = 32
MAX_HALO_STAGES = 16
MIN_TILE = 128


def _round4(n: int) -> int:
    return (n + 3) & ~3


def routed_tile_smem(tile: int, nplanes: int, esize: int) -> int:
    """Shared memory of the worst tile pass at tile T: a window of 2T slots
    (T plus halos of up to T) with NP words and 3 mask bytes a slot. A pass
    without a halo holds T slots and up to 5 mask bytes, always less."""
    return 2 * tile * (nplanes * esize + 3)


def routed_tile(nplanes: int, esize: int, limit: int | None = None) -> int:
    """Tile of the single-table kernels: the largest power of two whose
    worst pass fits `limit` bytes of shared memory (default: an H100's
    opt-in limit). 2^13 for a df64 pair, 2^14 for one f32 plane, 2^12 for
    an f64 pair on an H100."""
    limit = HOPPER_SMEM_OPTIN if limit is None else limit
    tile = MIN_TILE
    while routed_tile_smem(2 * tile, nplanes, esize) <= limit:
        tile *= 2
    return tile


def check_tile(tile: int, nplanes: int, esize: int, limit: int | None = None) -> None:
    """Raise for a tile the kernels cannot take: not a power of two >= 128,
    or its worst pass does not fit `limit` bytes of shared memory."""
    limit = HOPPER_SMEM_OPTIN if limit is None else limit
    if tile < MIN_TILE or tile & (tile - 1):
        raise ValueError(f"tile T={tile} must be a power of two >= {MIN_TILE}")
    if routed_tile_smem(tile, nplanes, esize) > limit:
        raise ValueError(
            f"tile T={tile} does not fit: {routed_tile_smem(tile, nplanes, esize)} "
            f"bytes of shared memory for {nplanes} plane(s) of {esize}-byte words "
            f"(limit {limit})")


@functools.lru_cache(maxsize=256)
def routed_passes(kinds: Tuple[str, ...], dists: Tuple[int, ...], m: int,
                  tile: int) -> Tuple[Tuple[str, int, int], ...]:
    """Cut a stage schedule into passes of csrc/tile_pass.cuh: a tuple of
    (kind, first stage, end stage), kind one of PASS_KINDS, the stages in
    order. Reads only kinds, dists, m and T (never the masks), so one cached
    schedule serves every call of a plan, forwards and (run last pass first)
    in reverse."""
    t = min(tile, m)
    high_ok = t < m <= t * t // 4
    passes = []
    cur = None  # [kind, start, end, xor stages, left halo, right halo]
    for s, (k, d) in enumerate(zip(kinds, dists)):
        kind = "low" if d < t else "high" if high_ok else "stage"
        left = cur[4] + (d if k == "shift" else 0) if cur else 0
        right = cur[5] + (d if k == "shiftl" else 0) if cur else 0
        fits = cur is not None and cur[0] == kind and kind != "stage"
        if fits and kind == "high":
            fits = s - cur[1] < MAX_PASS_STAGES
        elif fits and k == "xor":
            fits = cur[3] == s - cur[1] and s - cur[1] < MAX_PASS_STAGES
        elif fits:
            fits = (cur[3] == 0 and s - cur[1] < MAX_HALO_STAGES
                    and _round4(left) + _round4(right) <= t)
        if fits:
            cur[2], cur[4], cur[5] = s + 1, left, right
            cur[3] += k == "xor"
            continue
        if cur:
            passes.append(tuple(cur[:3]))
        cur = [kind, s, s + 1, int(k == "xor"), d if k == "shift" else 0,
               d if k == "shiftl" else 0]
    if cur:
        passes.append(tuple(cur[:3]))
    return tuple(passes)


@functools.lru_cache(maxsize=256)
def _network_args(kinds, dists, m: int, tile: int):
    """The C arrays of one call: stage kinds and distances, pass kinds and
    first stages, and the pass count. Cached with the schedule."""
    S = len(kinds)
    passes = routed_passes(kinds, dists, m, tile)
    n = max(len(passes), 1)
    return (
        (ctypes.c_int * max(S, 1))(*[_KIND_CODE[k] for k in kinds]),
        (ctypes.c_longlong * max(S, 1))(*[int(d) for d in dists]),
        len(passes),
        (ctypes.c_int * n)(*[_PASS_CODE[p[0]] for p in passes]),
        (ctypes.c_int * n)(*[p[1] for p in passes]),
    )


def _call_tile(tile, nplanes: int, esize: int, device) -> int:
    """The tile of one call: the caller's (a test forcing a small one),
    checked, or the largest that fits the device."""
    limit = smem_optin_bytes(device)
    if tile is None:
        return routed_tile(nplanes, esize, limit)
    check_tile(tile, nplanes, esize, limit)
    return tile


def masks_device(net, device="cuda") -> torch.Tensor:
    """Host masks [S, B, m] bool -> device bit-packed [B, P, R, 128] int8
    (bit s%8 of plane s//8 = stage s; see routed_apply)."""
    return torch.as_tensor(masks_packed(net.masks), device=device)


def masks_packed(masks: np.ndarray) -> np.ndarray:
    """Bit-pack host masks [S, B, m] bool into [B, P, R, 128] int8."""
    S, B, m = masks.shape
    R = m // 128
    if m % 1024:
        raise ValueError(f"network size m={m} must be a multiple of 1024")
    P = (S + 7) // 8
    packed = np.zeros((B, P, R, 128), dtype=np.uint8)
    mk = masks.transpose(1, 0, 2).reshape(B, S, R, 128)
    for s in range(S):
        packed[:, s // 8] |= mk[:, s].astype(np.uint8) << (s % 8)
    return packed.view(np.int8)


def _check_args(x_planes, masks, kinds, dists, per_net=False):
    """Validate a single-table call; value planes hold m words (one table
    shared by the B nets) or, with per_net, B * m words."""
    if masks.dim() != 4 or masks.shape[3] != 128 or masks.dtype != torch.int8:
        raise ValueError(
            f"masks must be int8 [B, P, R, 128], got {masks.dtype} "
            f"{tuple(masks.shape)}"
        )
    B, P, R, _ = masks.shape
    S = len(kinds)
    if S != len(dists) or P != (S + 7) // 8:
        raise ValueError(f"{S} kinds, {len(dists)} dists, {P} mask planes")
    m = R * 128
    if not 1 <= len(x_planes) <= 2:
        raise ValueError("routed_apply takes one or two value planes")
    dtype = x_planes[0].dtype
    if dtype not in _WORD_DTYPES:
        raise ValueError(f"value planes must be float32 or float64, got {dtype}")
    words = B * m if per_net else m
    for x in x_planes:
        if x.dtype != dtype or x.numel() != words or x.device != masks.device:
            raise ValueError(
                f"value plane {x.dtype} {tuple(x.shape)} on {x.device} does "
                f"not match {dtype} [{'%d, ' % B if per_net else ''}{R}, 128] "
                f"on {masks.device}"
            )
    for k, d in zip(kinds, dists):
        if k not in _KIND_CODE or not 1 <= d < m or d & (d - 1):
            raise ValueError(f"bad stage ({k!r}, {d}) for m={m}")
    return B, P, R, m, S, dtype


def routed_apply_plain(
    x_planes: Sequence[torch.Tensor],
    masks: torch.Tensor,
    kinds: Tuple[str, ...],
    dists: Tuple[int, ...],
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of routed_apply: the stage loop of
    GatherPlanHost.apply_host on the bit-packed masks, with torch.where and
    index arithmetic. Same arguments, same result, any device."""
    B, P, R, m, S, _ = _check_args(x_planes, masks, kinds, dists)
    idx = torch.arange(m, device=masks.device)
    planes = masks.reshape(B, P, m)
    ys = [x.reshape(1, m).expand(B, m) for x in x_planes]
    bits = None
    for s, (kind, d) in enumerate(zip(kinds, dists)):
        p, bit = divmod(s, 8)
        if bit == 0:
            bits = planes[:, p].to(torch.int32)
        mask = ((bits >> bit) & 1) != 0
        if kind == "xor":
            src = idx ^ d
        elif kind == "shiftl":
            src = (idx + d) % m
        else:
            src = (idx - d) % m
        ys = [torch.where(mask, y[:, src], y) for y in ys]
    return tuple(y.reshape(B, R, 128).contiguous() for y in ys)


def _lib():
    lib = _cuda.load("routed")
    fn = lib.lilac_routed_apply
    if not getattr(fn, "_typed", False):
        vp = ctypes.c_void_p
        fn.argtypes = [
            vp, vp, ctypes.c_int, ctypes.c_int, vp, vp, vp, vp, vp,
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_longlong),
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), vp,
        ]
        fn.restype = ctypes.c_int
        fn._typed = True
    return fn


def routed_apply(
    x_planes: Sequence[torch.Tensor],
    masks: torch.Tensor,
    kinds: Tuple[str, ...],
    dists: Tuple[int, ...],
    *,
    tile: int | None = None,
) -> Tuple[torch.Tensor, ...]:
    """Run B gather networks over shared input planes (kernel K1).

    x_planes: one or two [R, 128] value planes (e.g. (hi, lo) for df64),
              float32 or float64, all routed through identical switches.
    masks:    [B, ceil(S/8), R, 128] int8 bit-packed switch masks: bit
              (s % 8) of plane s // 8 is stage s's mask.
    tile:     slots of one shared-memory tile; None takes the largest that
              fits the device (routed_tile). A tile that is not a power of
              two >= 128 or does not fit raises, on any device.
    returns:  tuple of [B, R, 128] routed planes.

    CUDA tensors go through the kernel of csrc/routed.cu: the passes of
    routed_passes, one grid each on the current stream, ping-pong buffers
    from torch.empty; the launch error code is checked and raised. Only CPU
    tensors take the plain version."""
    if not masks.is_cuda:
        if tile is not None:
            _check_args(x_planes, masks, kinds, dists)
            check_tile(tile, len(x_planes), x_planes[0].element_size())
        return routed_apply_plain(x_planes, masks, kinds, dists)
    B, P, R, m, S, dtype = _check_args(x_planes, masks, kinds, dists)
    check_table_feasible(m, B, what="routed_apply")
    if not masks.is_contiguous() or masks.data_ptr() % 4:
        raise ValueError("masks must be contiguous and 4-byte aligned")
    xs = []
    for x in x_planes:
        if not x.is_contiguous() or x.data_ptr() % 32:
            raise ValueError("value planes must be contiguous and 32-byte aligned")
        xs.append(x)
    n = len(xs)
    tile = _call_tile(tile, n, xs[0].element_size(), masks.device)
    kinds_c, dists_c, npass, pkind_c, pstart_c = _network_args(
        tuple(kinds), tuple(dists), m, tile)
    outs = [torch.empty((B, R, 128), dtype=dtype, device=masks.device) for _ in xs]
    tmps = [torch.empty_like(o) for o in outs] if npass > 1 else outs
    fn = _lib()
    with torch.cuda.device(masks.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            xs[0].data_ptr(), xs[1].data_ptr() if n == 2 else None, n,
            xs[0].element_size(),
            outs[0].data_ptr(), outs[1].data_ptr() if n == 2 else None,
            tmps[0].data_ptr(), tmps[1].data_ptr() if n == 2 else None,
            masks.data_ptr(), B, P, m, S, kinds_c, dists_c, tile, npass,
            pkind_c, pstart_c, stream,
        )
    _cuda.check(err, "routed_apply")
    routed_apply.launches += 1
    routed_apply.stage_launches += max(npass, 1)
    return tuple(outs)


# wrapper calls that launched the kernel / CUDA grids (passes) those calls
# launched
routed_apply.launches = 0
routed_apply.stage_launches = 0


# ---- adjoint of the single-table network (K11) ------------------------------


def _merge_adj(kept, moved, dfpair: bool):
    """kept + moved per plane; for one df64 (hi, lo) pair Knuth's TwoSum of
    the hi words, the lo words and the error added, renormalised. Eager
    PyTorch rounds every op on its own, so the TwoSum is exact as written."""
    if dfpair and len(kept) == 2:
        s = kept[0] + moved[0]
        bb = s - kept[0]
        e = (kept[0] - (s - bb)) + (moved[0] - bb)
        low = e + (kept[1] + moved[1])
        hi = s + low
        return [hi, low - (hi - s)]
    return [k + mv for k, mv in zip(kept, moved)]


def _stage_adj_plain(ys, mask, kind: str, d: int, idx, dfpair: bool):
    """Adjoint of one forward stage over the last axis of `ys` (cyclic over
    its length, `idx` = arange of it). The merge is taken at every slot,
    also where nothing is moved in."""
    L = idx.shape[0]
    if kind == "xor":
        src = idx ^ d
        return [torch.where(mask, y[..., src], y) for y in ys]
    # the slot whose forward partner is i: shift reads i - d, so i + d
    src = (idx + d) % L if kind == "shift" else (idx - d) % L
    zero = ys[0].new_zeros(())
    kept = [torch.where(mask, zero, y) for y in ys]
    moved = [torch.where(mask, y, zero)[..., src] for y in ys]
    return _merge_adj(kept, moved, dfpair)


def routed_apply_t_plain(
    x_planes: Sequence[torch.Tensor],
    masks: torch.Tensor,
    kinds: Tuple[str, ...],
    dists: Tuple[int, ...],
    *,
    dfpair: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of routed_apply_t: the stages in reverse order,
    each by _stage_adj_plain. Same arguments, same result, any device."""
    B, P, R, m, S, _ = _check_args(x_planes, masks, kinds, dists, per_net=True)
    idx = torch.arange(m, device=masks.device)
    planes = masks.reshape(B, P, m)
    ys = [x.reshape(B, m) for x in x_planes]
    for s in range(S - 1, -1, -1):
        p, bit = divmod(s, 8)
        mask = ((planes[:, p].to(torch.int32) >> bit) & 1) != 0
        ys = _stage_adj_plain(ys, mask, kinds[s], dists[s], idx, dfpair)
    return tuple(y.reshape(B, R, 128).contiguous() for y in ys)


def _adj_lib():
    lib = _cuda.load("adjoint")
    if not getattr(lib, "_typed", False):
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        ub = ctypes.POINTER(ctypes.c_ubyte)
        head = [vp, vp, ci, ci, ll, vp, vp, ll, ci, ci, vp]
        lib.lilac_adj_window.argtypes = head + [
            ci, ci, ctypes.POINTER(ci), ci, ub, ci, ci, vp]
        lib.lilac_adj_bigshift.argtypes = head + [ci, ll, ci, ub, vp]
        lib.lilac_adj_routed.argtypes = [
            vp, vp, ci, ci, ci, vp, vp, vp, vp, vp, ci, ci, ll, ci,
            ctypes.POINTER(ci), ctypes.POINTER(ll), ci, ci, ctypes.POINTER(ci),
            ctypes.POINTER(ci), vp]
        for fn in (lib.lilac_adj_window, lib.lilac_adj_bigshift,
                   lib.lilac_adj_routed):
            fn.restype = ci
        lib._typed = True
    return lib


def routed_apply_t(
    x_planes: Sequence[torch.Tensor],
    masks: torch.Tensor,
    kinds: Tuple[str, ...],
    dists: Tuple[int, ...],
    *,
    dfpair: bool = False,
    tile: int | None = None,
) -> Tuple[torch.Tensor, ...]:
    """Adjoint of routed_apply (kernel K11): y = Gᵀ u for the same switch
    masks, so the transpose costs no plan bytes.

    x_planes: one or two per-net [B, R, 128] planes (the forward's output
              space); dfpair: they are one (hi, lo) df64 pair and the merges
              are compensated.
    tile:     as for routed_apply.
    returns:  tuple of [B, R, 128] planes in the forward's input space.

    CUDA tensors go through the kernel of csrc/adjoint.cu: routed_apply's
    passes run last to first, each pass's stages backwards, one grid each,
    ping-pong buffers from torch.empty (the input is only read); the launch
    error code is checked and raised. Only CPU tensors take the plain
    version."""
    if not masks.is_cuda:
        if tile is not None:
            _check_args(x_planes, masks, kinds, dists, per_net=True)
            check_tile(tile, len(x_planes), x_planes[0].element_size())
        return routed_apply_t_plain(x_planes, masks, kinds, dists, dfpair=dfpair)
    B, P, R, m, S, dtype = _check_args(x_planes, masks, kinds, dists, per_net=True)
    check_table_feasible(m, B, what="routed_apply_t")
    if not masks.is_contiguous() or masks.data_ptr() % 4:
        raise ValueError("masks must be contiguous and 4-byte aligned")
    for x in x_planes:
        if not x.is_contiguous() or x.data_ptr() % 32:
            raise ValueError("value planes must be contiguous and 32-byte aligned")
    xs = list(x_planes)
    n = len(xs)
    tile = _call_tile(tile, n, xs[0].element_size(), masks.device)
    kinds_c, dists_c, npass, pkind_c, pstart_c = _network_args(
        tuple(kinds), tuple(dists), m, tile)
    outs = [torch.empty((B, R, 128), dtype=dtype, device=masks.device) for _ in xs]
    tmps = [torch.empty_like(o) for o in outs] if npass > 1 else outs
    fn = _adj_lib().lilac_adj_routed
    with torch.cuda.device(masks.device):
        err = fn(
            xs[0].data_ptr(), xs[1].data_ptr() if n == 2 else None, n,
            xs[0].element_size(), int(bool(dfpair)),
            outs[0].data_ptr(), outs[1].data_ptr() if n == 2 else None,
            tmps[0].data_ptr(), tmps[1].data_ptr() if n == 2 else None,
            masks.data_ptr(), B, P, m, S, kinds_c, dists_c, tile, npass,
            pkind_c, pstart_c, torch.cuda.current_stream().cuda_stream,
        )
    _cuda.check(err, "routed_apply_t")
    routed_apply_t.launches += 1
    routed_apply_t.stage_launches += max(npass, 1)
    return tuple(outs)


routed_apply_t.launches = 0
routed_apply_t.stage_launches = 0


# ---------------------------------------------------------------------------
# Hierarchical networks (m beyond one resident table).
#
# A stage schedule over m = nblocks * bl slots is cut into passes by stage
# distance d against the block length bl:
#
#   xor,   d <  bl -> inner pass (K3): all consecutive block-local stages of
#                     one block run in shared memory
#   xor,   d >= bl -> butterfly pass (K4): g <= gmax stages at distances
#                     bl * 2^bit exchange whole blocks elementwise inside
#                     groups of 2^g blocks
#   shift, d <  bl -> window pass (K5): <= 8 shift stages with sum(d) < bl
#                     over the window (block b - 1, block b)
#   shift, d >= bl -> bigshift pass (K6): one block-aligned shift
#
# A butterfly pass writes each group's 2^g member blocks contiguously
# (group-major), so the physical block order leaves the pass scrambled; the
# next pass reads logical block b at physical block _phys_expr(b, layout).
# `layout` is a permutation of the block-index bits: physical bit k holds
# logical bit layout[k]; None is the identity. Inner, window and bigshift
# passes write natural order.
#
# Mask layouts are the plan file's and the JAX package's, per pass:
#   inner     [nblocks, P, R, 128] int8, bit s%8 of plane s//8 = stage s
#   butterfly [ngroups, G*R, 128]  int8, bit k = stage k, member-major rows
#   window    [nblocks, 2R, 128]   int8, bit s = stage s, rows [0, R) the
#                                  left neighbour's switches (0 for block 0)
#   bigshift  [nblocks, R, 128]    int8, 0 / 1
# with R = bl // 128. The net-batched appliers (`*_b`) take the same arrays
# stacked on a leading net axis N and planes shared by all nets
# ([mrows, 128]) or per net ([N, mrows, 128]); they return [N, mrows, 128].
# The un-batched appliers are the same kernels at N = 1.
#
# The adjoint appliers (`*_bt`, K7-K10) take the SAME mask arrays, net-batched
# only (one net is N = 1), and per-net [N, mrows, 128] planes. hier_apply_
# batched_t runs a schedule's passes in reverse order; the layout bookkeeping
# is the forward's over the reversed pass list (each adjoint pass reads
# logical blocks through the current layout and writes natural order, the
# butterfly adjoint group-major), and the forward's final relayout has no
# adjoint step: the natural-order cotangent is the logical-indexed view.
# The window adjoint of block b needs the window (block b, block b + 1), the
# mirror of the forward's (b - 1, b); its masks are the self halves (rows
# [R, 2R)) of the packed blocks b and b + 1.
# ---------------------------------------------------------------------------

# Dynamic shared memory one thread block of an H100 may ask for (227 KB of
# the SM's 256 KB). Taken for plans staged on the CPU; on a card the limit is
# read from the device (smem_optin_bytes).
HOPPER_SMEM_OPTIN = 232448

_smem_limits: dict = {}


def _identity_bitmap(nbits: int) -> Tuple[int, ...]:
    return tuple(range(nbits))


def _phys_expr(idx, bitmap):
    """Physical block index of logical block `idx` (int, numpy or tensor)
    under a block bit-permutation: physical bit k holds logical bit
    bitmap[k]."""
    out = 0
    for k, srcbit in enumerate(bitmap):
        out = out + ((idx >> srcbit) & 1) * (1 << k)
    return out


def _nbits(nblocks: int) -> int:
    if nblocks < 1 or nblocks & (nblocks - 1):
        raise ValueError(f"block count {nblocks} must be a power of two")
    return nblocks.bit_length() - 1


def _norm_layout(layout, nblocks: int) -> Tuple[int, ...]:
    nbits = _nbits(nblocks)
    if layout is None:
        return _identity_bitmap(nbits)
    layout = tuple(int(b) for b in layout)
    if sorted(layout) != list(range(nbits)):
        raise ValueError(
            f"layout {layout} is not a permutation of {nbits} block bits")
    return layout


def _phys_index(nblocks: int, layout, device) -> torch.Tensor:
    """[nblocks] int64: physical block of each logical block."""
    table = _phys_expr(np.arange(nblocks, dtype=np.int64),
                       _norm_layout(layout, nblocks))
    table = np.array(np.broadcast_to(table, (nblocks,)), dtype=np.int64)
    return torch.as_tensor(table, device=device)


def smem_optin_bytes(device="cuda") -> int:
    """Dynamic shared memory a block may opt in to on `device`: asked of the
    card (cudaDevAttrMaxSharedMemoryPerBlockOptin), HOPPER_SMEM_OPTIN for
    the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return HOPPER_SMEM_OPTIN
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _smem_limits:
        out = ctypes.c_int(0)
        with torch.cuda.device(index):
            _cuda.check(_hier_lib().lilac_hier_smem_optin(ctypes.byref(out)),
                        "smem_optin_bytes")
        _smem_limits[index] = int(out.value)
    return _smem_limits[index]


def default_hier_bl(limit: int = HOPPER_SMEM_OPTIN) -> int:
    """Block length of hierarchical plans when LILAC_HIER_BL is unset.

    A window pass may hold up to bl + sum(d) < 2 * bl slots on chip at 8
    bytes a slot (a df64 (hi, lo) pair or one f64 word, the widest the NPB
    path routes) and one mask byte each, at most 2 * 9 * bl bytes
    (pass_smem_bytes); the default is the largest power of two that bound
    fits in the opt-in limit: 2 * 9 * bl <= 232448 gives bl = 2^13 on an
    H100. The window adjoint (K9) stages less: span + sum(d) slots of each
    of its two buffers (window_bt_span). The inner pass (K3, K7) holds one
    block of bl slots and one 32-bit mask word a slot, 12 * bl bytes at 25
    stages: two such blocks share an SM at 2^13. The forward window,
    butterfly and bigshift passes hold no slots on chip."""
    bl = 128
    while 2 * 9 * (2 * bl) <= limit:
        bl *= 2
    return bl


def hier_gmax(bl: int, nplanes: int) -> int:
    """Largest butterfly group exponent. The butterfly kernel holds its 2^g
    words per offset in registers and nothing in shared memory, so no
    on-chip budget depends on bl or nplanes: g = 3, the widest group the
    kernel is instantiated for."""
    return 3


def pass_smem_bytes(p, bl: int, nplanes: int, esize: int = 4) -> int:
    """Dynamic shared memory of one compiled pass descriptor's kernels: the
    larger of the forward's and the adjoint's, since one plan serves both
    directions."""
    kind = p[0]
    if kind == "inner":
        # the block's 32-bit words and one mask word a slot per 32 stages
        return (nplanes * esize // 4 + (len(p[1]) + 31) // 32) * bl * 4
    if kind == "window":
        # one window of bl + sum(d) slots (rounded up to 4) with their mask
        # bytes, the plan's budget for a window pass. The kernels stage
        # less: the adjoint two buffers of span + sum(d) slots
        # (window_bt_smem_bytes; window_bt_span keeps them within the
        # device's limit), the forward only the mask bytes its span of
        # output slots can reach (window_smem_bytes)
        slots = (bl + sum(p[1]) + 3) // 4 * 4
        return slots * (nplanes * esize + 1)
    if kind in ("butterfly", "bigshift"):
        return 0
    raise ValueError(f"unknown pass kind {kind!r}")


def check_smem_feasible(passes, bl: int, nplanes: int, esize: int = 4, *,
                        limit: int | None = None, what: str = "") -> None:
    """Raise at plan-build / load time when a pass cannot run: bl not a
    power of two >= 128, a butterfly group wider than 2^3, or a pass whose
    shared memory exceeds `limit` (default: an H100's opt-in limit)."""
    if limit is None:
        limit = HOPPER_SMEM_OPTIN
    what = what or "config"
    if bl < 128 or bl & (bl - 1):
        raise ValueError(
            f"routed plan {what}: block length bl={bl} must be a power of "
            "two >= 128")
    for p in passes:
        if p[0] == "butterfly" and not 1 <= len(p[1]) <= 3:
            raise ValueError(
                f"routed plan {what}: butterfly group of {len(p[1])} stages "
                "(the kernel takes 1 to 3; lower LILAC_HIER_GMAX)")
    worst = max(((p[0], pass_smem_bytes(p, bl, nplanes, esize)) for p in passes),
                key=lambda t: t[1], default=("none", 0))
    if worst[1] > limit:
        raise ValueError(
            f"routed plan {what} does not fit shared memory: pass "
            f"'{worst[0]}' needs {worst[1]} bytes a block at bl={bl}, "
            f"{nplanes} plane(s) of {esize}-byte words; the limit is {limit}. "
            "Lower LILAC_HIER_BL.")
    if any(p[0] == "inner" for p in passes) and bl > INNER_MAX_BL:
        raise ValueError(
            f"routed plan {what}: block length bl={bl} is more than the inner "
            f"pass's {INNER_MAX_BL} (1024 threads of {1 << INNER_MAX_REG_BITS} "
            "slots). Lower LILAC_HIER_BL.")


# ---- register schedule of the inner pass (K3, K3u, K7) ---------------------
#
# csrc/inner_pass.cuh runs an inner pass with a block's bl = 2^L slots
# spread over the registers of its threads: a slot index splits into rb
# register bits (2^rb slots a thread), 5 lane bits and L - rb - 5 warp bits.
# An xor stage whose distance bit is a register bit is a select between two
# registers of a thread, on a lane bit a warp shuffle; a stage on a warp bit
# never runs in place. So the pass is cut into RUNS of consecutive stages,
# each with its own assignment of slot bits (`perm`: bit t of
# (thread << rb | register) is slot bit perm[t]), and the block goes once
# through shared memory between runs. There it is stored swizzled, every
# slot bit j folded onto bank bit j % 5: a run's lane bits have distinct
# residues mod 5, so a warp's 32 lanes reach 32 banks. A run holds at most
# 16 stages inside one 32-stage mask word. Any stage order is served; an
# order whose stages wander over many bits only costs more runs.

INNER_LANE_BITS = 5
INNER_MAX_REG_BITS = 4
INNER_MAX_BL = 1024 << INNER_MAX_REG_BITS
INNER_MAX_STAGES = 64
INNER_MAX_RUN = 16  # a thread keeps a run's switches of two slots in one register


def inner_reg_bits(bl: int) -> int:
    """Register bits of the inner pass at block length bl: 16 slots a thread
    where the block has room for them beside 5 lane bits, fewer below 2^9."""
    return min(INNER_MAX_REG_BITS, bl.bit_length() - 1 - INNER_LANE_BITS)


def _run_layout(bits, L: int, rb: int):
    """The assignment of one run whose distance bits are `bits` (stage
    order): a tuple perm of the L slot bits, register bits first, then the 5
    lane bits (one of each residue mod 5), then the warp bits; or None where
    no assignment holds every distance bit in a register or a lane. Of the
    assignments that do, the one with the fewest shuffle stages."""
    need = set(bits)
    if len(need) > rb + INNER_LANE_BITS:
        return None
    freq = Counter(bits)
    classes = [[j for j in range(L) if j % INNER_LANE_BITS == c]
               for c in range(INNER_LANE_BITS)]
    best = None
    for lanes in itertools.product(*classes):
        regs = need.difference(lanes)
        if len(regs) > rb:
            continue
        key = (sum(freq[b] for b in lanes), lanes)
        if best is None or key < best[0]:
            best = (key, lanes, regs)
    if best is None:
        return None
    _, lanes, regs = best
    rest = [j for j in range(L) if j not in lanes and j not in regs]
    fill = rb - len(regs)
    return tuple(sorted(regs)) + tuple(rest[:fill]) + tuple(lanes) + tuple(rest[fill:])


@functools.lru_cache(maxsize=256)
def inner_runs(dists: Tuple[int, ...], bl: int, rb: int | None = None
               ) -> Tuple[Tuple[int, int, Tuple[int, ...]], ...]:
    """Cut an inner pass's xor stages into runs: a tuple of (first stage,
    end stage, perm), the stages in order, each run's distance bits all
    register or lane bits of its perm (see above). Reads only the distances,
    bl and rb, so one cached schedule serves every call of a plan, forwards
    and (runs last one first) in reverse. Runs are as long as they can be,
    which gives the fewest."""
    L = bl.bit_length() - 1
    rb = inner_reg_bits(bl) if rb is None else rb
    if bl != 1 << L or not 2 <= rb <= INNER_MAX_REG_BITS or rb + INNER_LANE_BITS > L \
            or bl >> rb > 1024:
        raise ValueError(f"inner pass: no register schedule for bl={bl}, rb={rb}")
    bits = []
    for d in dists:
        if not 1 <= d < bl or d & (d - 1):
            raise ValueError(f"inner pass: bad xor distance {d} for bl={bl}")
        bits.append(d.bit_length() - 1)
    runs = []
    a = 0
    while a < len(bits):
        b = a + 1
        perm = _run_layout(bits[a:b], L, rb)
        while b < len(bits) and b % 32 and b - a < INNER_MAX_RUN:
            nxt = _run_layout(bits[a:b + 1], L, rb)
            if nxt is None:
                break
            perm, b = nxt, b + 1
        runs.append((a, b, perm))
        a = b
    return tuple(runs)


def inner_stage_codes(dists, runs, rb: int) -> Tuple[int, ...]:
    """Per stage, what the kernel exchanges across: register bit q (q), or
    lane bit q (8 + q), in its run's assignment."""
    codes = []
    for a, b, perm in runs:
        for d in dists[a:b]:
            t = perm.index(d.bit_length() - 1)
            codes.append(t if t < rb else 8 + t - rb)
    return tuple(codes)


class _InnerRun(ctypes.Structure):
    _fields_ = [("a", ctypes.c_ubyte), ("b", ctypes.c_ubyte),
                ("perm", ctypes.c_ubyte * 16)]


class _InnerSched(ctypes.Structure):  # inner::Sched of csrc/inner_pass.cuh
    _fields_ = [("nruns", ctypes.c_int), ("rb", ctypes.c_int),
                ("code", ctypes.c_ubyte * INNER_MAX_STAGES),
                ("run", _InnerRun * INNER_MAX_STAGES)]  # at most a run a stage


@functools.lru_cache(maxsize=256)
def _inner_sched(dists: Tuple[int, ...], bl: int, rb: int) -> _InnerSched:
    """The C struct of one pass's schedule, cached with it."""
    runs = inner_runs(dists, bl, rb)
    sc = _InnerSched()
    sc.nruns, sc.rb = len(runs), rb
    for s, c in enumerate(inner_stage_codes(dists, runs, rb)):
        sc.code[s] = c
    for r, (a, b, perm) in enumerate(runs):
        sc.run[r].a, sc.run[r].b = a, b
        for t, bit in enumerate(perm):
            sc.run[r].perm[t] = bit
    return sc


def compile_hier(kinds, dists, masks_host, bl: int, *, gmax: int = 2):
    """Split one network's stage schedule into hierarchical passes.

    masks_host: [S, m] bool (one network). Returns a tuple of pass
    descriptors with HOST (numpy int8) mask arrays, bit-identical to the JAX
    package's for the same bl / gmax:
      ('inner', kinds, dists, masks [nblocks, P, R, 128] bit-packed)
      ('butterfly', block_bits, masks [ngroups, G*R, 128] bit-packed)
      ('window', dists, masks [nblocks, 2R, 128] bit-packed)
      ('bigshift', d, masks [nblocks, R, 128] 0/1)
    The arrays stay on the host so that a plan is uploaded once, stacked
    (routed_spmv.pack_hier)."""
    S, m = masks_host.shape
    R = bl // 128
    nblocks = m // bl
    if gmax < 1:
        raise ValueError("gmax must be >= 1")
    if nblocks * bl != m or bl % 128:
        raise ValueError(f"m={m} is not a multiple of bl={bl} (a multiple of 128)")
    nbits = _nbits(nblocks)
    # monotone ('shiftl') schedules are single-table-only by design: their
    # shift stages cannot group into butterfly passes
    if not all(k in ("xor", "shift") for k in kinds):
        raise ValueError(f"hierarchical schedules take xor / shift stages, got {kinds}")

    def flush_inner(buf, out):
        if not buf:
            return
        ks = tuple(k for k, _, _ in buf)
        ds = tuple(d for _, d, _ in buf)
        Srun = len(buf)
        P = (Srun + 7) // 8
        packed = np.zeros((nblocks, P, R, 128), dtype=np.uint8)
        for s, (_, _, mask) in enumerate(buf):
            packed[:, s // 8] |= (
                mask.reshape(nblocks, R, 128).astype(np.uint8) << (s % 8))
        out.append(("inner", ks, ds, packed.view(np.int8)))
        buf.clear()

    def flush_outer(buf, out):
        while buf:
            grp = []
            used_bits = set()
            while buf and len(grp) < gmax:
                d, _ = buf[0]
                bit = int(np.log2(d // bl))
                if bit in used_bits:
                    break
                used_bits.add(bit)
                grp.append(buf.pop(0))
            bits = tuple(int(np.log2(d // bl)) for d, _ in grp)
            G = 1 << len(bits)
            rest = [b for b in range(nbits) if b not in bits]
            # member-major grouped mask rows: logical block of (group, member)
            gid = np.arange(nblocks // G, dtype=np.int64)[:, None]
            mem = np.arange(G, dtype=np.int64)[None, :]
            bid = np.zeros((nblocks // G, G), dtype=np.int64)
            for i, b in enumerate(rest):
                bid |= ((gid >> i) & 1) << b
            for kk, b in enumerate(bits):
                bid |= ((mem >> kk) & 1) << b
            packed = np.zeros((nblocks // G, G, R, 128), dtype=np.uint8)
            for k, (_, mask) in enumerate(grp):
                packed |= mask.reshape(nblocks, R, 128).astype(np.uint8)[bid] << k
            out.append(("butterfly", bits,
                        packed.reshape(nblocks // G, G * R, 128).view(np.int8)))

    def flush_window(buf, out):
        if not buf:
            return
        ds = tuple(d for d, _ in buf)
        assert sum(ds) < bl and len(buf) <= 8
        packed = np.zeros((nblocks, 2 * R, 128), dtype=np.uint8)
        for s, (_, mask) in enumerate(buf):
            mk = mask.reshape(nblocks, R, 128).astype(np.uint8)
            packed[:, R:] |= mk << s
            packed[1:, :R] |= mk[:-1] << s  # left neighbour; block 0's left = 0
        out.append(("window", ds, packed.view(np.int8)))
        buf.clear()

    passes: list = []
    inner_buf: list = []
    outer_buf: list = []
    win_buf: list = []
    for s in range(S):
        k, d, mk = kinds[s], int(dists[s]), masks_host[s]
        if k == "xor" and d < bl:
            flush_outer(outer_buf, passes)
            flush_window(win_buf, passes)
            inner_buf.append((k, d, mk))
        elif k == "xor":
            flush_inner(inner_buf, passes)
            flush_window(win_buf, passes)
            outer_buf.append((d, mk))
        elif d >= bl:  # block-aligned long shift (very long broadcast run)
            if d % bl:
                raise ValueError(f"shift distance {d} is not a multiple of bl={bl}")
            flush_inner(inner_buf, passes)
            flush_outer(outer_buf, passes)
            flush_window(win_buf, passes)
            passes.append(
                ("bigshift", d, mk.reshape(nblocks, R, 128).astype(np.int8)))
        else:  # short shift, fused into a window pass
            flush_inner(inner_buf, passes)
            flush_outer(outer_buf, passes)
            if win_buf and (
                sum(x for x, _ in win_buf) + d >= bl or len(win_buf) >= 8
            ):
                flush_window(win_buf, passes)
            win_buf.append((d, mk))
    flush_inner(inner_buf, passes)
    flush_outer(outer_buf, passes)
    flush_window(win_buf, passes)
    return tuple(passes)


# ---- arguments shared by the appliers --------------------------------------


def _hier_planes(x_planes, N: int, nblocks: int, bl: int, device, what: str):
    """Validate value planes against a pass over N nets of nblocks blocks.
    Returns (dtype, shared): shared = one [mrows, 128] plane for all nets."""
    if not 1 <= len(x_planes) <= 2:
        raise ValueError(f"{what} takes one or two value planes")
    dtype = x_planes[0].dtype
    if dtype not in _WORD_DTYPES:
        raise ValueError(f"value planes must be float32 or float64, got {dtype}")
    mrows = nblocks * (bl // 128)
    shared = x_planes[0].dim() == 2
    want = (mrows, 128) if shared else (N, mrows, 128)
    for x in x_planes:
        if x.dtype != dtype or tuple(x.shape) != want or x.device != device:
            raise ValueError(
                f"{what}: value plane {x.dtype} {tuple(x.shape)} on {x.device} "
                f"does not match {dtype} {want} (or {(mrows, 128)} shared) on "
                f"{device}")
    return dtype, shared


def _net_masks(masks: torch.Tensor, net_axis: bool, inner: bool, what: str):
    """Masks with the net axis in front ([N, ...]); un-batched masks get
    N = 1 as a view."""
    rank = (4 if inner else 3) + (1 if net_axis else 0)
    if masks.dim() != rank or masks.shape[-1] != 128 or masks.dtype != torch.int8:
        raise ValueError(
            f"{what}: masks must be int8 with {rank} axes ending in 128, got "
            f"{masks.dtype} {tuple(masks.shape)}")
    return masks if net_axis else masks.unsqueeze(0)


def _blocks(x: torch.Tensor, nblocks: int, bl: int) -> torch.Tensor:
    """A [mrows, 128] or [N, mrows, 128] plane as [1 or N, nblocks, bl]."""
    return x.reshape(1 if x.dim() == 2 else x.shape[0], nblocks, bl)


def _finish(ys, N, nblocks, bl, net_axis):
    outs = tuple(y.reshape(N, nblocks * (bl // 128), 128).contiguous() for y in ys)
    return outs if net_axis else tuple(o[0] for o in outs)


def _butterfly_maps(nblocks: int, block_bits, layout):
    """Host tables of one butterfly pass: (rest, new_layout, gid_pos,
    mem_phys). Group index bit i is logical block bit rest[i]; member s sets
    logical bits block_bits[k] for the set bits k of s. gid_pos / mem_phys
    give the same in PHYSICAL block bits under `layout`."""
    nbits = _nbits(nblocks)
    bits = tuple(int(b) for b in block_bits)
    if len(set(bits)) != len(bits) or not all(0 <= b < nbits for b in bits):
        raise ValueError(f"bad butterfly block bits {bits} for {nbits} block bits")
    lay = _norm_layout(layout, nblocks)
    rest = [b for b in range(nbits) if b not in bits]
    pos_of = {logical: k for k, logical in enumerate(lay)}
    gid_pos = [pos_of[b] for b in rest]
    mem_phys = [
        sum(((s >> k) & 1) << pos_of[b] for k, b in enumerate(bits))
        for s in range(1 << len(bits))
    ]
    return rest, bits + tuple(rest), gid_pos, mem_phys


# ---- plain PyTorch versions -------------------------------------------------


def routed_apply_sliced_plain(x_planes, masks, kinds, dists, *, layout=None):
    """Plain version of routed_apply_sliced(_b): every block runs the stage
    loop of routed_apply_plain on its own bl slots (shifts are cyclic over
    the block). masks [nblocks, P, R, 128], or [N, nblocks, P, R, 128] for
    the net-batched form."""
    net_axis = masks.dim() == 5
    mk = _net_masks(masks, net_axis, True, "routed_apply_sliced")
    N, nblocks, P, R, _ = mk.shape
    bl = R * 128
    S = len(kinds)
    if S != len(dists) or (S and P != (S + 7) // 8):
        raise ValueError(f"{S} kinds, {len(dists)} dists, {P} mask planes")
    _hier_planes(x_planes, N, nblocks, bl, mk.device, "routed_apply_sliced")
    phys = _phys_index(nblocks, layout, mk.device)
    idx = torch.arange(bl, device=mk.device)
    planes = mk.reshape(N, nblocks, P, bl)
    ys = [_blocks(x, nblocks, bl)[:, phys].expand(N, nblocks, bl) for x in x_planes]
    bits = None
    for s, (kind, d) in enumerate(zip(kinds, dists)):
        if kind not in _KIND_CODE or not 1 <= d < bl:
            raise ValueError(f"bad stage ({kind!r}, {d}) for bl={bl}")
        p, bit = divmod(s, 8)
        if bit == 0:
            bits = planes[:, :, p].to(torch.int32)
        mask = ((bits >> bit) & 1) != 0
        if kind == "xor":
            src = idx ^ d
        elif kind == "shiftl":
            src = (idx + d) % bl
        else:
            src = (idx - d) % bl
        ys = [torch.where(mask, y[..., src], y) for y in ys]
    return _finish(ys, N, nblocks, bl, net_axis)


def butterfly_apply_plain(x_planes, masks, block_bits, bl: int, *, layout=None,
                          reverse: bool = False):
    """Plain version of butterfly_apply(_b). masks [ngroups, G*R, 128] or
    [N, ngroups, G*R, 128]. Returns (planes, new_layout). reverse: the g
    stages last one first (the adjoint pass, butterfly_apply_bt_plain)."""
    net_axis = masks.dim() == 4
    mk = _net_masks(masks, net_axis, False, "butterfly_apply")
    N, ngroups = mk.shape[:2]
    g = len(block_bits)
    G = 1 << g
    nblocks = ngroups * G
    if mk.shape[2] * 128 != G * bl:
        raise ValueError(f"butterfly masks {tuple(mk.shape)} do not match G={G}, bl={bl}")
    _hier_planes(x_planes, N, nblocks, bl, mk.device, "butterfly_apply")
    rest, new_layout, _, _ = _butterfly_maps(nblocks, block_bits, layout)
    gid = np.arange(ngroups, dtype=np.int64)[:, None]
    mem = np.arange(G, dtype=np.int64)[None, :]
    bid = np.zeros((ngroups, G), dtype=np.int64)
    for i, b in enumerate(rest):
        bid |= ((gid >> i) & 1) << b
    for k, b in enumerate(block_bits):
        bid |= ((mem >> k) & 1) << int(b)
    src = _phys_index(nblocks, layout, mk.device)[
        torch.as_tensor(bid, device=mk.device)]  # [ngroups, G] physical blocks
    mbits = mk.reshape(N, ngroups, G, bl).to(torch.int32)
    members = torch.arange(G, device=mk.device)
    cur = [_blocks(x, nblocks, bl)[:, src].expand(N, ngroups, G, bl) for x in x_planes]
    for k in (range(g - 1, -1, -1) if reverse else range(g)):
        msk = ((mbits >> k) & 1) != 0
        cur = [torch.where(msk, y[:, :, members ^ (1 << k)], y) for y in cur]
    return _finish(cur, N, nblocks, bl, net_axis), new_layout


def window_shift_apply_plain(x_planes, masks, dists, bl: int, *, layout=None):
    """Plain version of window_shift_apply(_b): the stage loop over the
    (left neighbour, self) window of 2 * bl slots, cyclic inside the window,
    of which the upper half is kept. masks [nblocks, 2R, 128] or
    [N, nblocks, 2R, 128]."""
    net_axis = masks.dim() == 4
    mk = _net_masks(masks, net_axis, False, "window_shift_apply")
    N, nblocks = mk.shape[:2]
    S = len(dists)
    if mk.shape[2] * 128 != 2 * bl:
        raise ValueError(f"window masks {tuple(mk.shape)} do not match bl={bl}")
    if S > 8 or sum(dists) >= bl or any(d < 1 for d in dists):
        raise ValueError(f"window pass takes <= 8 shifts with sum < bl, got {dists}")
    _hier_planes(x_planes, N, nblocks, bl, mk.device, "window_shift_apply")
    phys = _phys_index(nblocks, layout, mk.device)
    left = phys[(torch.arange(nblocks, device=mk.device) + nblocks - 1) % nblocks]
    mbits = mk.reshape(N, nblocks, 2 * bl).to(torch.int32)
    outs = []
    for x in x_planes:
        xb = _blocks(x, nblocks, bl)
        y = torch.cat([xb[:, left], xb[:, phys]], dim=-1).expand(N, nblocks, 2 * bl)
        for s, d in enumerate(dists):
            msk = ((mbits >> s) & 1) != 0
            y = torch.where(msk, torch.roll(y, d, dims=-1), y)
        outs.append(y[..., bl:])
    return _finish(outs, N, nblocks, bl, net_axis)


def bigshift_apply_plain(x_planes, masks, d: int, bl: int, *, layout=None):
    """Plain version of bigshift_apply(_b): out = mask ? block b - d/bl :
    block b. masks [nblocks, R, 128] or [N, nblocks, R, 128]."""
    net_axis = masks.dim() == 4
    mk = _net_masks(masks, net_axis, False, "bigshift_apply")
    N, nblocks = mk.shape[:2]
    if mk.shape[2] * 128 != bl or d % bl:
        raise ValueError(f"bigshift masks {tuple(mk.shape)} / d={d} do not match bl={bl}")
    _hier_planes(x_planes, N, nblocks, bl, mk.device, "bigshift_apply")
    db = (d // bl) % nblocks
    phys = _phys_index(nblocks, layout, mk.device)
    far = phys[(torch.arange(nblocks, device=mk.device) + nblocks - db) % nblocks]
    msk = mk.reshape(N, nblocks, bl) != 0
    outs = []
    for x in x_planes:
        xb = _blocks(x, nblocks, bl)
        outs.append(torch.where(msk, xb[:, far], xb[:, phys]))
    return _finish(outs, N, nblocks, bl, net_axis)


# ---- plain PyTorch versions of the adjoint passes ---------------------------


def _adj_args(x_planes, masks, inner: bool, what: str):
    """Net-batched masks and per-net planes, as every adjoint pass takes."""
    mk = _net_masks(masks, True, inner, what)
    for x in x_planes:
        if x.dim() != 3:
            raise ValueError(
                f"{what}: adjoint passes take per-net [N, mrows, 128] planes, "
                f"got {tuple(x.shape)}")
    return mk


def routed_apply_sliced_bt_plain(x_planes, masks, kinds, dists, *,
                                 dfpair: bool = False, layout=None):
    """Plain version of routed_apply_sliced_bt: every block runs its stages
    in reverse order by _stage_adj_plain on its own bl slots (shifts cyclic
    over the block). masks [N, nblocks, P, R, 128]."""
    what = "routed_apply_sliced_bt"
    mk = _adj_args(x_planes, masks, True, what)
    N, nblocks, P, R, _ = mk.shape
    bl = R * 128
    S = len(kinds)
    if S != len(dists) or (S and P != (S + 7) // 8):
        raise ValueError(f"{S} kinds, {len(dists)} dists, {P} mask planes")
    _hier_planes(x_planes, N, nblocks, bl, mk.device, what)
    phys = _phys_index(nblocks, layout, mk.device)
    idx = torch.arange(bl, device=mk.device)
    planes = mk.reshape(N, nblocks, P, bl)
    ys = [_blocks(x, nblocks, bl)[:, phys] for x in x_planes]
    for s in range(S - 1, -1, -1):
        kind, d = kinds[s], dists[s]
        if kind not in _KIND_CODE or not 1 <= d < bl:
            raise ValueError(f"bad stage ({kind!r}, {d}) for bl={bl}")
        p, bit = divmod(s, 8)
        mask = ((planes[:, :, p].to(torch.int32) >> bit) & 1) != 0
        ys = _stage_adj_plain(ys, mask, kind, d, idx, dfpair)
    return _finish(ys, N, nblocks, bl, True)


def butterfly_apply_bt_plain(x_planes, masks, block_bits, bl: int, *, layout=None):
    """Plain version of butterfly_apply_bt: the forward's exchange stages
    last one first. masks [N, ngroups, G*R, 128]. Returns (planes,
    new_layout)."""
    _adj_args(x_planes, masks, False, "butterfly_apply_bt")
    return butterfly_apply_plain(x_planes, masks, block_bits, bl, layout=layout,
                                 reverse=True)


def window_shift_apply_bt_plain(x_planes, masks, dists, bl: int, *,
                                dfpair: bool = False, layout=None):
    """Plain version of window_shift_apply_bt: the shift stages in reverse
    order as add-merges over the (self, right neighbour) window of 2 * bl
    slots, cyclic inside the window, of which the lower half is kept. masks
    [N, nblocks, 2R, 128], the forward's."""
    what = "window_shift_apply_bt"
    mk = _adj_args(x_planes, masks, False, what)
    N, nblocks = mk.shape[:2]
    S = len(dists)
    if mk.shape[2] * 128 != 2 * bl:
        raise ValueError(f"window masks {tuple(mk.shape)} do not match bl={bl}")
    if S > 8 or sum(dists) >= bl or any(d < 1 for d in dists):
        raise ValueError(f"window pass takes <= 8 shifts with sum < bl, got {dists}")
    _hier_planes(x_planes, N, nblocks, bl, mk.device, what)
    phys = _phys_index(nblocks, layout, mk.device)
    nxt = (torch.arange(nblocks, device=mk.device) + 1) % nblocks
    own = mk.reshape(N, nblocks, 2 * bl)[..., bl:]  # each block's own switches
    mbits = torch.cat([own, own[:, nxt]], dim=-1).to(torch.int32)
    idx = torch.arange(2 * bl, device=mk.device)
    ys = []
    for x in x_planes:
        xb = _blocks(x, nblocks, bl)
        ys.append(torch.cat([xb[:, phys], xb[:, phys[nxt]]], dim=-1))
    for s in range(S - 1, -1, -1):
        msk = ((mbits >> s) & 1) != 0
        ys = _stage_adj_plain(ys, msk, "shift", dists[s], idx, dfpair)
    return _finish([y[..., :bl] for y in ys], N, nblocks, bl, True)


def bigshift_apply_bt_plain(x_planes, masks, d: int, bl: int, *,
                            dfpair: bool = False, layout=None):
    """Plain version of bigshift_apply_bt: block b's unmasked words plus the
    masked words of block b + d/bl. masks [N, nblocks, R, 128]."""
    what = "bigshift_apply_bt"
    mk = _adj_args(x_planes, masks, False, what)
    N, nblocks = mk.shape[:2]
    if mk.shape[2] * 128 != bl or d % bl:
        raise ValueError(f"bigshift masks {tuple(mk.shape)} / d={d} do not match bl={bl}")
    _hier_planes(x_planes, N, nblocks, bl, mk.device, what)
    db = (d // bl) % nblocks
    phys = _phys_index(nblocks, layout, mk.device)
    far = (torch.arange(nblocks, device=mk.device) + db) % nblocks
    msk = mk.reshape(N, nblocks, bl) != 0
    zero = x_planes[0].new_zeros(())
    kept, moved = [], []
    for x in x_planes:
        xb = _blocks(x, nblocks, bl)
        kept.append(torch.where(msk, zero, xb[:, phys]))
        moved.append(torch.where(msk[:, far], xb[:, phys[far]], zero))
    return _finish(_merge_adj(kept, moved, dfpair), N, nblocks, bl, True)


# ---- the CUDA kernels of csrc/hier.cu and csrc/adjoint.cu --------------------


def _hier_lib():
    lib = _cuda.load("hier")
    if not getattr(lib, "_typed", False):
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        ub = ctypes.POINTER(ctypes.c_ubyte)
        head = [vp, vp, ci, ci, ll, vp, vp, ll, ci, ci, vp]
        for fn in (lib.lilac_hier_inner, lib.lilac_hier_inner_t):
            fn.argtypes = head + [ci, ci, ub, ci, ub, vp, vp]
        lib.lilac_hier_inner_attrs.argtypes = [ci, ci, ci, ci, ci, ctypes.POINTER(ci)]
        for fn in (lib.lilac_hier_butterfly, lib.lilac_hier_butterfly_t):
            fn.argtypes = head + [ci, ci, ub, ctypes.POINTER(ci), vp]
        lib.lilac_hier_window.argtypes = head + [
            ci, ctypes.POINTER(ci), ci, ub, ci, vp]
        lib.lilac_hier_bigshift.argtypes = head + [ll, ci, ub, vp]
        lib.lilac_hier_smem_optin.argtypes = [ctypes.POINTER(ci)]
        for fn in (lib.lilac_hier_inner, lib.lilac_hier_butterfly,
                   lib.lilac_hier_window, lib.lilac_hier_bigshift,
                   lib.lilac_hier_inner_t, lib.lilac_hier_butterfly_t,
                   lib.lilac_hier_smem_optin, lib.lilac_hier_inner_attrs):
            fn.restype = ci
        lib._typed = True
    return lib


def _ubytes(values):
    return (ctypes.c_ubyte * max(len(values), 1))(*values)


def _launch_hier(fn_name, what, x_planes, mk, N, nblocks, bl, tail, lib=_hier_lib):
    """Common half of the pass launches: checks the tensors, allocates the
    [N, mrows, 128] outputs and calls the C function `fn_name` of `lib()`
    with the arguments all passes share, then the kernel's own (`tail`), then
    the current stream."""
    dtype, shared = _hier_planes(x_planes, N, nblocks, bl, mk.device, what)
    if not mk.is_contiguous() or mk.data_ptr() % 4:
        raise ValueError(f"{what}: masks must be contiguous and 4-byte aligned")
    for x in x_planes:
        if not x.is_contiguous() or x.data_ptr() % 32:
            raise ValueError(
                f"{what}: value planes must be contiguous and 32-byte aligned")
    if N > _MAX_NETS or nblocks > _MAX_NETS:
        raise ValueError(f"{what}: {N} nets x {nblocks} blocks (limit {_MAX_NETS} each)")
    m = nblocks * bl
    n = len(x_planes)
    outs = [torch.empty((N, m // 128, 128), dtype=dtype, device=mk.device)
            for _ in x_planes]
    fn = getattr(lib(), fn_name)
    with torch.cuda.device(mk.device):
        err = fn(
            x_planes[0].data_ptr(), x_planes[1].data_ptr() if n == 2 else None,
            n, x_planes[0].element_size(), 0 if shared else m,
            outs[0].data_ptr(), outs[1].data_ptr() if n == 2 else None,
            m, N, bl, mk.data_ptr(), *tail,
            torch.cuda.current_stream().cuda_stream,
        )
    _cuda.check(err, what)
    return tuple(outs)


def _inner(x_planes, masks, kinds, dists, layout, net_axis, reverse=False,
           reg_bits=None):
    """The CUDA inner pass, forward or (reverse) adjoint: xor stages only,
    which are their own adjoints, so the adjoint is the stage loop run
    backwards. reg_bits forces the schedule's register bits, for checks of
    the other instantiations only; every wrapper takes inner_reg_bits(bl)."""
    what = "routed_apply_sliced_bt" if reverse else "routed_apply_sliced"
    mk = _net_masks(masks, net_axis, True, what)
    N, nblocks, P, R, _ = mk.shape
    bl = R * 128
    S = len(kinds)
    if S != len(dists) or (S and P != (S + 7) // 8) or S > INNER_MAX_STAGES:
        raise ValueError(
            f"{what}: {S} kinds, {len(dists)} dists, {P} mask planes (at most "
            "64 stages a pass)")
    for k, d in zip(kinds, dists):
        if k != "xor":
            raise NotImplementedError(
                f"{what}: the CUDA inner pass runs xor stages only (compile_hier "
                f"builds no other kind into an inner pass), got {k!r}")
        if not 1 <= d < bl or d & (d - 1):
            raise ValueError(f"{what}: bad xor distance {d} for bl={bl}")
    lay = _norm_layout(layout, nblocks)
    check_smem_feasible(
        (("inner", kinds, dists),), bl, len(x_planes), x_planes[0].element_size(),
        limit=smem_optin_bytes(mk.device), what=what)
    rb = inner_reg_bits(bl) if reg_bits is None else reg_bits
    sched = _inner_sched(tuple(int(d) for d in dists), bl, rb)
    tail = (P, S, _ubytes([int(d).bit_length() - 1 for d in dists]),
            len(lay), _ubytes(lay), ctypes.addressof(sched))
    outs = _launch_hier("lilac_hier_inner_t" if reverse else "lilac_hier_inner",
                        what, x_planes, mk, N, nblocks, bl, tail)
    return outs if net_axis else tuple(o[0] for o in outs)


def inner_launch_config(nplanes: int, esize: int, bl: int, dists, *, N: int = 1,
                        nblocks: int = 1, device="cuda") -> dict:
    """How the CUDA inner pass launches for one shape, for reports: grid,
    threads, dynamic shared memory and registers of a thread block, thread
    blocks resident on one SM, spilled bytes, and the runs of the stage
    schedule."""
    rb = inner_reg_bits(bl)
    dists = tuple(int(d) for d in dists)
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(torch.device(device)):
        _cuda.check(_hier_lib().lilac_hier_inner_attrs(
            nplanes, esize, bl, (len(dists) + 7) // 8, rb, out), "inner_launch_config")
    return {"grid": [nblocks, N], "threads": out[0],
            "smem_bytes": out[1], "ctas_per_sm": out[2], "regs": out[3],
            "local_bytes": out[4], "reg_bits": rb,
            "runs": [[a, b] for a, b, _ in inner_runs(dists, bl, rb)]}


def routed_apply_sliced_b(x_planes, masks, kinds, dists, *, layout=None):
    """Net-batched inner pass (kernel K3). masks [N, nblocks, P, R, 128];
    x_planes each [mrows, 128] (shared input) or [N, mrows, 128]. Logical
    block b is read at physical block _phys_expr(b, layout); the result is
    [N, mrows, 128] planes in natural block order.

    CUDA tensors go through csrc/inner_pass.cuh (one launch, grid
    (nblocks, N), the stages in registers by the schedule of inner_runs),
    which runs xor stages only and raises NotImplementedError for others;
    the launch error code is raised. Only CPU tensors take the plain
    version."""
    if not masks.is_cuda:
        return routed_apply_sliced_plain(x_planes, masks, kinds, dists, layout=layout)
    outs = _inner(x_planes, masks, kinds, dists, layout, True)
    routed_apply_sliced_b.launches += 1
    return outs


def routed_apply_sliced(x_planes, masks, kinds, dists, *, layout=None):
    """Inner pass of one net (kernel K3u: K3 at N = 1). masks
    [nblocks, P, R, 128]; planes [mrows, 128] in and out."""
    if not masks.is_cuda:
        return routed_apply_sliced_plain(x_planes, masks, kinds, dists, layout=layout)
    outs = _inner(x_planes, masks, kinds, dists, layout, False)
    routed_apply_sliced.launches += 1
    return outs


def _butterfly(x_planes, masks, block_bits, bl, layout, net_axis, reverse=False):
    if not masks.is_cuda:
        return butterfly_apply_plain(x_planes, masks, block_bits, bl,
                                     layout=layout, reverse=reverse)
    what = "butterfly_apply_bt" if reverse else "butterfly_apply"
    mk = _net_masks(masks, net_axis, False, what)
    N, ngroups = mk.shape[:2]
    g = len(block_bits)
    if not 1 <= g <= 3:
        raise ValueError(f"{what}: the kernel takes 1 to 3 stages a pass, got {g}")
    G = 1 << g
    nblocks = ngroups * G
    if mk.shape[2] * 128 != G * bl:
        raise ValueError(f"{what}: masks {tuple(mk.shape)} do not match G={G}, bl={bl}")
    rest, new_layout, gid_pos, mem_phys = _butterfly_maps(nblocks, block_bits, layout)
    tail = (g, len(rest), _ubytes(gid_pos), (ctypes.c_int * 8)(*mem_phys))
    outs = _launch_hier(
        "lilac_hier_butterfly_t" if reverse else "lilac_hier_butterfly", what,
        x_planes, mk, N, nblocks, bl, tail)
    return (outs if net_axis else tuple(o[0] for o in outs)), new_layout


def butterfly_apply_b(x_planes, masks, block_bits, bl: int, *, layout=None):
    """Net-batched butterfly pass (kernel K4): g = len(block_bits) <= 3 xor
    stages at distances bl * 2^block_bits[k], k in stage order. masks
    [N, ngroups, G*R, 128]. Writes each group's 2^g member blocks
    contiguously; returns (planes [N, mrows, 128], new_layout) with
    new_layout = block_bits + the remaining bits. CUDA tensors take the
    kernel, CPU tensors the plain version."""
    out = _butterfly(x_planes, masks, block_bits, bl, layout, True)
    if masks.is_cuda:
        butterfly_apply_b.launches += 1
    return out


def butterfly_apply(x_planes, masks, block_bits, bl: int, *, layout=None):
    """Butterfly pass of one net (kernel K4u: K4 at N = 1). masks
    [ngroups, G*R, 128]. Returns (planes [mrows, 128], new_layout)."""
    out = _butterfly(x_planes, masks, block_bits, bl, layout, False)
    if masks.is_cuda:
        butterfly_apply.launches += 1
    return out


WINDOW_SPAN = 128  # output slots of one window thread block (4 a thread)


def window_span(bl: int, span: int | None = None) -> int:
    """Output slots of one thread block of the window pass: the caller's (a
    test forcing another), checked, or WINDOW_SPAN. A power of two from 128
    to min(bl, 4096) (4 slots a thread, at most 1024 threads)."""
    if span is None:
        return WINDOW_SPAN
    if span < 128 or span & (span - 1) or span > min(bl, 4096):
        raise ValueError(
            f"window span {span} must be a power of two from 128 to min(bl={bl}, 4096)")
    return span


def window_smem_bytes(span: int, dists) -> int:
    """Shared memory of one thread block of the forward window pass: the mask
    bytes its walks can read, span + sum(d) positions from a 16-byte
    boundary."""
    return (span + sum(dists) + 30) & ~15


def _window(x_planes, masks, dists, bl, layout, net_axis, span=None):
    if not masks.is_cuda:
        if span is not None:
            window_span(bl, span)
        return window_shift_apply_plain(x_planes, masks, dists, bl, layout=layout)
    what = "window_shift_apply"
    mk = _net_masks(masks, net_axis, False, what)
    N, nblocks = mk.shape[:2]
    S = len(dists)
    if mk.shape[2] * 128 != 2 * bl:
        raise ValueError(f"{what}: masks {tuple(mk.shape)} do not match bl={bl}")
    if S > 8 or sum(dists) >= bl or any(d < 1 for d in dists):
        raise ValueError(f"{what}: takes <= 8 shifts with sum < bl, got {dists}")
    if mk.data_ptr() % 16:
        raise ValueError(f"{what}: masks must be 16-byte aligned")
    span = window_span(bl, span)
    lay = _norm_layout(layout, nblocks)
    check_smem_feasible(
        (("window", dists),), bl, len(x_planes), x_planes[0].element_size(),
        limit=smem_optin_bytes(mk.device), what=what)
    tail = (S, (ctypes.c_int * 8)(*[int(d) for d in dists]), len(lay), _ubytes(lay), span)
    outs = _launch_hier("lilac_hier_window", what, x_planes, mk, N, nblocks, bl, tail)
    return outs if net_axis else tuple(o[0] for o in outs)


def window_launch_config(bl: int, dists, *, N: int = 1, nblocks: int = 1) -> dict:
    """How the forward window pass launches for one shape, for reports."""
    span = window_span(bl)
    return {"grid": [nblocks * (bl // span), N], "threads": span // 4,
            "span": span, "smem_bytes": window_smem_bytes(span, dists)}


def window_shift_apply_b(x_planes, masks, dists, bl: int, *, layout=None, span=None):
    """Net-batched window pass (kernel K5): <= 8 fused shift stages
    y[i] <- y[i - d] where mask, sum(d) < bl, over the window (block b - 1,
    block b); writes block b in natural order. masks [N, nblocks, 2R, 128].
    span forces the output slots of one thread block (window_span), for
    checks only. CUDA tensors take the kernel, CPU tensors the plain
    version."""
    outs = _window(x_planes, masks, dists, bl, layout, True, span)
    if masks.is_cuda:
        window_shift_apply_b.launches += 1
    return outs


def window_shift_apply(x_planes, masks, dists, bl: int, *, layout=None, span=None):
    """Window pass of one net (kernel K5u: K5 at N = 1). masks
    [nblocks, 2R, 128]."""
    outs = _window(x_planes, masks, dists, bl, layout, False, span)
    if masks.is_cuda:
        window_shift_apply.launches += 1
    return outs


def _bigshift(x_planes, masks, d, bl, layout, net_axis):
    if not masks.is_cuda:
        return bigshift_apply_plain(x_planes, masks, d, bl, layout=layout)
    what = "bigshift_apply"
    mk = _net_masks(masks, net_axis, False, what)
    N, nblocks = mk.shape[:2]
    if mk.shape[2] * 128 != bl or d % bl:
        raise ValueError(f"{what}: masks {tuple(mk.shape)} / d={d} do not match bl={bl}")
    lay = _norm_layout(layout, nblocks)
    tail = ((d // bl) % nblocks, len(lay), _ubytes(lay))
    outs = _launch_hier("lilac_hier_bigshift", what, x_planes, mk, N, nblocks, bl, tail)
    return outs if net_axis else tuple(o[0] for o in outs)


def bigshift_apply_b(x_planes, masks, d: int, bl: int, *, layout=None):
    """Net-batched block-aligned shift (kernel K6): d a multiple of bl,
    out = mask ? logical block b - d/bl : logical block b, natural order.
    masks [N, nblocks, R, 128] 0/1. CUDA tensors take the kernel, CPU
    tensors the plain version."""
    outs = _bigshift(x_planes, masks, d, bl, layout, True)
    if masks.is_cuda:
        bigshift_apply_b.launches += 1
    return outs


def bigshift_apply(x_planes, masks, d: int, bl: int, *, layout=None):
    """Block-aligned shift of one net (kernel K6u: K6 at N = 1). masks
    [nblocks, R, 128]."""
    outs = _bigshift(x_planes, masks, d, bl, layout, False)
    if masks.is_cuda:
        bigshift_apply.launches += 1
    return outs


# ---- the adjoint passes (K7-K10) ----------------------------------------------


def routed_apply_sliced_bt(x_planes, masks, kinds, dists, *, dfpair: bool = False,
                           layout=None):
    """Net-batched inner-pass adjoint (kernel K7): the pass's stages in
    reverse order. masks [N, nblocks, P, R, 128], the forward's; x_planes
    per-net [N, mrows, 128] cotangents, logical block b read at physical
    block _phys_expr(b, layout); natural block order out.

    CUDA tensors go through csrc/inner_pass.cuh (K3's kernel with the runs
    and their stages running backwards: xor stages are their own adjoints and need no merge,
    so `dfpair` changes nothing there); other stage kinds raise
    NotImplementedError. Only CPU tensors take the plain version, which
    serves all three kinds."""
    if not masks.is_cuda:
        return routed_apply_sliced_bt_plain(
            x_planes, masks, kinds, dists, dfpair=dfpair, layout=layout)
    _adj_args(x_planes, masks, True, "routed_apply_sliced_bt")
    outs = _inner(x_planes, masks, kinds, dists, layout, True, reverse=True)
    routed_apply_sliced_bt.launches += 1
    return outs


def butterfly_apply_bt(x_planes, masks, block_bits, bl: int, *, layout=None):
    """Net-batched butterfly adjoint (kernel K8): the g exchange stages last
    one first (each is its own adjoint). Reads logical member blocks through
    `layout`, writes group-major like the forward; returns (planes
    [N, mrows, 128], new_layout). A pure permutation: a df64 pair rides as
    two planes. CUDA tensors take the kernel (csrc/hier.cu), CPU tensors the
    plain version."""
    _adj_args(x_planes, masks, False, "butterfly_apply_bt")
    out = _butterfly(x_planes, masks, block_bits, bl, layout, True, reverse=True)
    if masks.is_cuda:
        butterfly_apply_bt.launches += 1
    return out


WINDOW_BT_MIN_SPAN = 512  # output slots of one K9 span, at least (bl permitting)
WINDOW_BT_SPANS = 16  # spans one K9 thread block takes in turn, at most


def window_bt_smem_bytes(span: int, dists, nplanes: int, esize: int, spans: int = 1) -> int:
    """Shared memory of one thread block of the window-pass adjoint (K9): its
    input slots (two where it takes several spans in turn, one span's copies
    landing while the other's stages run; else one), each the span + sum(d)
    words of every plane (rounded up to 4) and their mask bytes (rounded up
    to 32), and one more buffer of words for the stages' ping-pong."""
    reach = span + sum(dists)
    slots = 2 if spans > 1 else 1
    return (slots + 1) * nplanes * esize * ((reach + 3) & ~3) + slots * ((reach + 31) & ~31)


@functools.lru_cache(maxsize=None)
def window_bt_span(bl: int, dists: Tuple[int, ...], nplanes: int = 2, esize: int = 4,
                   limit: int = HOPPER_SMEM_OPTIN) -> int:
    """Output slots of one span of the window-pass adjoint (K9).

    The smallest power of two C >= WINDOW_BT_MIN_SPAN (or bl, if smaller)
    whose halo sum(d) is at most C / 4 (so at most a fifth of the slots a
    span computes are thrown away), or bl where no C <= bl is that wide;
    halved while its two buffers (one span at a time) exceed `limit`.
    Class D's shifts (sum 15) take 512, the general matrix's (sum 255)
    1024, the fastest spans at those shapes (`chip_smoke.py window_bt_diag`).
    C = 128 fits every pass check_smem_feasible admits: its footprint, 2
    (128 + sum(d)) words a plane and as many mask bytes, is under the one
    window of bl + sum(d) slots that check allows once bl >= 255 * (bytes a
    slot) + 160, and under 140 000 bytes below that."""
    sumd = sum(dists)
    span = min(WINDOW_BT_MIN_SPAN, bl)
    while span < bl and 4 * sumd > span:
        span *= 2
    while span > 128 and window_bt_smem_bytes(span, dists, nplanes, esize) > limit:
        span //= 2
    return span


def window_bt_spans(bl: int, span: int, dists, nplanes: int, esize: int,
                    limit: int = HOPPER_SMEM_OPTIN) -> int:
    """Spans one K9 thread block takes in turn: WINDOW_BT_SPANS (at most the
    bl / span of a window block) where the two input slots fit `limit`,
    else 1."""
    spans = min(bl // span, WINDOW_BT_SPANS)
    if spans > 1 and window_bt_smem_bytes(span, dists, nplanes, esize, spans) <= limit:
        return spans
    return 1


def window_bt_launch_config(bl: int, dists, nplanes: int, esize: int, *, N: int = 1,
                            nblocks: int = 1) -> dict:
    """How the window-pass adjoint launches for one shape, for reports."""
    span = window_bt_span(bl, tuple(dists), nplanes, esize)
    spans = window_bt_spans(bl, span, dists, nplanes, esize)
    return {"grid": [nblocks * (bl // span) // spans, N],
            "threads": min(span // 4, 1024), "span": span, "spans_per_block": spans,
            "smem_bytes": window_bt_smem_bytes(span, dists, nplanes, esize, spans)}


def window_shift_apply_bt(x_planes, masks, dists, bl: int, *, dfpair: bool = False,
                          layout=None, span=None):
    """Net-batched window-pass adjoint (kernel K9): the fused shift stages in
    reverse order as add-merges u'[i] = (1 - m[i]) u[i] + m[i + d] u[i + d]
    over the window (block b, block b + 1); writes block b in natural order.
    masks [N, nblocks, 2R, 128], the forward's (the self halves are read),
    16-byte aligned. span forces the output slots of one thread block
    (window_bt_span), for checks only. CUDA tensors take the kernel
    (csrc/adjoint.cu), CPU tensors the plain version."""
    what = "window_shift_apply_bt"
    if span is not None and (span < 128 or span & (span - 1) or span > bl):
        raise ValueError(f"{what}: span {span} must be a power of two from 128 to bl={bl}")
    if masks.data_ptr() % 16:
        raise ValueError(f"{what}: masks must be 16-byte aligned")
    if not masks.is_cuda:
        return window_shift_apply_bt_plain(
            x_planes, masks, dists, bl, dfpair=dfpair, layout=layout)
    mk = _adj_args(x_planes, masks, False, what)
    N, nblocks = mk.shape[:2]
    S = len(dists)
    if mk.shape[2] * 128 != 2 * bl:
        raise ValueError(f"{what}: masks {tuple(mk.shape)} do not match bl={bl}")
    if S > 8 or sum(dists) >= bl or any(d < 1 for d in dists):
        raise ValueError(f"{what}: takes <= 8 shifts with sum < bl, got {dists}")
    nplanes, esize = len(x_planes), x_planes[0].element_size()
    limit = smem_optin_bytes(mk.device)
    check_smem_feasible((("window", dists),), bl, nplanes, esize, limit=limit, what=what)
    if span is None:
        span = window_bt_span(bl, tuple(dists), nplanes, esize, limit)
    elif window_bt_smem_bytes(span, dists, nplanes, esize) > limit:
        raise ValueError(f"{what}: span {span} needs more than the {limit} bytes of "
                         "shared memory a block may hold")
    spans = window_bt_spans(bl, span, dists, nplanes, esize, limit)
    lay = _norm_layout(layout, nblocks)
    tail = (int(bool(dfpair)), S, (ctypes.c_int * 8)(*[int(d) for d in dists]),
            len(lay), _ubytes(lay), span, spans)
    outs = _launch_hier("lilac_adj_window", what, x_planes, mk, N, nblocks, bl,
                        tail, lib=_adj_lib)
    window_shift_apply_bt.launches += 1
    return outs


def bigshift_apply_bt(x_planes, masks, d: int, bl: int, *, dfpair: bool = False,
                      layout=None):
    """Net-batched block-aligned shift adjoint (kernel K10): d a multiple of
    bl; block b keeps its unmasked words and adds the masked words of block
    b + d/bl, natural order out. masks [N, nblocks, R, 128] 0/1. CUDA tensors
    take the kernel (csrc/adjoint.cu), CPU tensors the plain version."""
    if not masks.is_cuda:
        return bigshift_apply_bt_plain(
            x_planes, masks, d, bl, dfpair=dfpair, layout=layout)
    what = "bigshift_apply_bt"
    mk = _adj_args(x_planes, masks, False, what)
    N, nblocks = mk.shape[:2]
    if mk.shape[2] * 128 != bl or d % bl:
        raise ValueError(f"{what}: masks {tuple(mk.shape)} / d={d} do not match bl={bl}")
    lay = _norm_layout(layout, nblocks)
    tail = (int(bool(dfpair)), (d // bl) % nblocks, len(lay), _ubytes(lay))
    outs = _launch_hier("lilac_adj_bigshift", what, x_planes, mk, N, nblocks, bl,
                        tail, lib=_adj_lib)
    bigshift_apply_bt.launches += 1
    return outs


# wrapper calls that launched their kernel
HIER_WRAPPERS = (
    routed_apply_sliced_b, butterfly_apply_b, window_shift_apply_b,
    bigshift_apply_b, routed_apply_sliced, butterfly_apply,
    window_shift_apply, bigshift_apply,
    routed_apply_sliced_bt, butterfly_apply_bt, window_shift_apply_bt,
    bigshift_apply_bt,
)
for _w in HIER_WRAPPERS:
    _w.launches = 0


# ---- whole schedules ---------------------------------------------------------


def _run_passes(planes, metas, masks, bl, fns):
    """Apply passes in order, tracking the block layout across butterfly
    passes; returns (planes, layout) with layout None = natural order."""
    inner, butterfly, window, bigshift = fns
    layout = None
    for meta, mk in zip(metas, masks):
        kind = meta[0]
        if kind == "inner":
            planes = inner(planes, mk, meta[1], meta[2], layout=layout)
            layout = None
        elif kind == "butterfly":
            planes, layout = butterfly(planes, mk, meta[1], bl, layout=layout)
            if tuple(layout) == tuple(range(len(layout))):
                layout = None
        elif kind == "bigshift":
            planes = bigshift(planes, mk, meta[1], bl, layout=layout)
            layout = None
        elif kind == "window":
            planes = window(planes, mk, meta[1], bl, layout=layout)
            layout = None
        else:
            raise ValueError(f"unknown pass kind {kind!r}")
    return planes, layout


def _relayout(planes, layout, bl):
    """Static block relayout after a schedule that ends scrambled: logical
    block b lives at physical block _phys_expr(b, layout)."""
    R = bl // 128
    nblocks = planes[0].shape[-2] // R
    phys = _phys_index(nblocks, layout, planes[0].device)
    out = []
    for pp in planes:
        lead = pp.shape[:-2]
        blocks = pp.reshape(*lead, nblocks, R, 128)
        out.append(blocks.index_select(len(lead), phys).reshape(pp.shape))
    return tuple(out)


def hier_apply_batched(x_planes, pass_meta, pass_masks, bl: int):
    """Apply one shared pass schedule to N nets at once.

    x_planes: shared [mrows, 128] planes (every net routes the same input).
    pass_meta: the static HierNet.pass_meta tuple shared by all N nets;
    pass_masks: per pass, the N nets' masks stacked on a leading axis.
    Returns per-net [N, mrows, 128] planes in natural order. Each pass
    allocates its output and drops its input, so two [N, m] buffers a plane
    are live at a time (three during the final relayout)."""
    planes, layout = _run_passes(
        tuple(x_planes), pass_meta, pass_masks, bl,
        (routed_apply_sliced_b, butterfly_apply_b, window_shift_apply_b,
         bigshift_apply_b))
    if planes and planes[0].dim() == 2:  # an empty schedule: N copies
        N = pass_masks[0].shape[0] if pass_masks else 1
        planes = tuple(p.unsqueeze(0).expand(N, *p.shape).contiguous() for p in planes)
    if layout is not None:
        planes = _relayout(planes, layout, bl)
    return planes


def hier_apply_batched_t(x_planes, pass_meta, pass_masks, bl: int, *,
                         dfpair: bool = False):
    """Adjoint of hier_apply_batched: the shared pass schedule in REVERSE
    over N per-net cotangent planes [N, mrows, 128]. Returns per-net
    [N, mrows, 128] planes in the forward's input space, natural block
    order. The layout starts natural (the forward's final relayout needs no
    adjoint step), is set only by a butterfly adjoint, and a last relayout
    undoes what the sweep's last butterfly left."""
    planes, layout = _run_passes(
        tuple(x_planes), tuple(reversed(pass_meta)), tuple(reversed(pass_masks)),
        bl,
        (functools.partial(routed_apply_sliced_bt, dfpair=dfpair),
         butterfly_apply_bt,
         functools.partial(window_shift_apply_bt, dfpair=dfpair),
         functools.partial(bigshift_apply_bt, dfpair=dfpair)))
    if layout is not None:
        planes = _relayout(planes, layout, bl)
    return planes


def hier_apply(x_planes, passes, bl: int):
    """Apply a compile_hier pass sequence (descriptors with their masks as
    tensors on the planes' device) to [m // 128, 128] planes of one net."""
    planes, layout = _run_passes(
        tuple(x_planes), [p[:-1] for p in passes], [p[-1] for p in passes], bl,
        (routed_apply_sliced, butterfly_apply, window_shift_apply, bigshift_apply))
    if layout is not None:
        planes = _relayout(planes, layout, bl)
    return planes
