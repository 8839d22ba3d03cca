"""Plan-time gather routing networks (host construction).

Counterpart of lilac_tpu/kernels/routenet.py (numpy only), held
bit-identical to it by tests/test_torch_routed.py. A gather
`out[k] = x[idx[k]]` with idx known at PLAN time is realizable as a
static network of masked exchange / shift stages:

    1. Beneš permutation routing each distinct needed value from its
       natural slot v to `first_v` = the first position of its run in
       sorted(idx)                                  [2*log2(m) - 1 stages]
    2. monotone run broadcast: position k with offset o = k - first(run)
       copies from k - 2^j at stage j = floor(log2(o)) — source offsets
       are < 2^j, already filled by earlier stages   [log2(max_run) stages]
    3. Beneš permutation from sorted order to the requested slot order
       (out[ord[p]] = sorted_gather[p], ord = argsort(idx))
                                                    [2*log2(m) - 1 stages]

All stages are the same primitive: y[i] = mask[i] ? y[partner(i)] : y[i]
with partner = i XOR d (Beneš exchange) or i - d (broadcast shift), d a
power of two. Switch masks depend only on idx — computed here once,
applied on device by kernels/routed.py. All-zero stages are dropped.

Construction is fully vectorized and level-batched (a recursive
per-subproblem constructor spends its time in millions of tiny
sub-problems; here every level is one numpy pass over [B, m] arrays, and
independent networks are batched on the leading axis).

Whether such a network beats the card's own gather on an H100 is an open
measurement (PERF.md); the port carries the networks because they are the
operator the reference runs.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# batched Beneš construction
# ---------------------------------------------------------------------------


def _two_color_batched(
    nbr_a: np.ndarray, nbr_b: np.ndarray, max_cycle: int | None = None
) -> np.ndarray:
    """2-color the union of two perfect matchings on [B, m] arrays of
    LOCAL neighbor indices (each row independent; cycles never cross rows).

    Returns color[B, m] in {0, 1} with color[e] != color[nbr_a[e]] and
    color[e] != color[nbr_b[e]] (even cycles guarantee 2-colorability).
    max_cycle bounds the cycle length (the Beneš block size), limiting
    the pointer-jumping rounds at deep recursion levels.
    """
    B, m = nbr_a.shape
    if max_cycle is None:
        max_cycle = m
    rows = np.arange(B)[:, None]
    step = nbr_b[rows, nbr_a]  # even-distance walk: preserves orbit
    leader = np.broadcast_to(np.arange(m, dtype=np.int32), (B, m)).copy()
    hop = step.copy()
    for _ in range(int(np.ceil(np.log2(max(max_cycle, 2)))) + 1):
        leader = np.minimum(leader, leader[rows, hop])
        hop = hop[rows, hop]
    # orbit(e) and orbit(nbr_a[e]) partition each cycle; compare leaders
    color = (leader > leader[rows, nbr_a]).astype(np.int8)
    return color


def benes_route_batched(perm: np.ndarray) -> List[Tuple[int, np.ndarray]]:
    """Switch settings realizing element x[i] -> position perm[i], batched.

    perm: [B, m] (each row a permutation of 0..m-1), m a power of two.
    Returns [(distance, mask[B, m])] with 2*log2(m) - 1 stages; stage
    semantics: y[i] = x[i ^ d] if mask[..., i] else x[i] (consistent
    exchanges: mask[i] == mask[i ^ d]).
    """
    perm = np.asarray(perm, dtype=np.int32)
    if perm.ndim == 1:
        perm = perm[None]
    B, m = perm.shape
    assert m & (m - 1) == 0 and m >= 2
    nlev = int(np.log2(m))
    rows = np.arange(B)[:, None]
    e_glob = np.broadcast_to(np.arange(m, dtype=np.int32), (B, m))

    in_stages: List[Tuple[int, np.ndarray]] = []
    out_stages: List[Tuple[int, np.ndarray]] = []

    cur = perm.copy()  # block-local permutations at current level
    for lev in range(nlev - 1):
        ml = m >> lev  # block size
        h = ml // 2
        e_loc = e_glob & (ml - 1)
        base = e_glob - e_loc
        # local inverse within blocks
        inv = np.empty_like(cur)
        np.put_along_axis(inv, base + cur, e_loc, axis=1)
        nbr_in = base + (e_loc ^ h)
        nbr_out = base + inv[rows, base + ((cur + h) & (ml - 1))]
        color = _two_color_batched(nbr_in, nbr_out, max_cycle=ml)
        # even-cycle 2-coloring is always consistent (leader comparison
        # flips across both matchings); assert rather than silently
        # mis-route if an invariant is ever violated
        assert (color != color[rows, nbr_in]).all(), "benes coloring failed"

        # input exchange at (i, i + h): swap iff low element's color is 1
        low_color = np.where(e_loc < h, color, color[rows, nbr_in])
        swap_in = low_color == 1
        # output exchange at destinations (j, j + h): element landing at
        # local j comes from subnetwork color[elem]; swap iff color of the
        # element destined for the LOW output is 1
        elem_at_out_low = inv[
            rows, base + np.where((e_loc & h) == 0, e_loc, e_loc ^ h)
        ]
        swap_out = color[rows, base + elem_at_out_low] == 1
        in_stages.append((h, swap_in))
        out_stages.append((h, swap_out))

        # positions after the input stage: element from local slot i sits
        # at (i mod h) + h * color; next-level blocks are the two halves
        pos_after = base + (e_loc % h) + h * color.astype(np.int32)
        elem_at = np.empty_like(cur)  # element sitting at each slot
        np.put_along_axis(elem_at, pos_after, e_glob, axis=1)
        # sub-permutation: element must exit its subnetwork at (dest mod h)
        nxt = cur[rows, elem_at] & (h - 1)
        cur = nxt

    # base level: blocks of 2, one exchange stage at distance 1
    swap_base = cur != (e_glob & 1)
    stages = in_stages + [(1, swap_base)] + out_stages[::-1]
    return stages


def _benes_stages_many(perms) -> List[List[Tuple[int, np.ndarray]]]:
    """Beneš switch masks for several batches of permutations ([B, m] each,
    one m), one stage list per batch.

    Prefers the native C constructor (sequential cycle-walk colouring,
    far faster on the host than the numpy pointer-jumping path);
    falls back to benes_route_batched. Colourings (hence masks) differ
    between the two, but both realize the same permutations. The C router
    runs outside the GIL, so the permutations of a call are routed on
    threads; each result depends on its own permutation only."""
    from lilac_tpu_torch import native

    m = perms[0].shape[1]
    if m < 4 or not native.available():  # pragma: no cover - toolchain missing
        return [benes_route_batched(p) for p in perms]
    nlev = int(np.log2(m))
    S = 2 * nlev - 1
    dists = [m >> (lv + 1) for lv in range(nlev)] + [
        m >> (nlev - lv) for lv in range(1, nlev)
    ]
    masks = [np.empty((S, p.shape[0], m), dtype=bool) for p in perms]
    jobs = [(k, b) for k, p in enumerate(perms) for b in range(p.shape[0])]

    def route(job):
        k, b = job
        masks[k][:, b, :] = native.benes_route(perms[k][b]).astype(bool)

    workers = min(len(jobs), os.cpu_count() or 1)
    if workers <= 1:
        for job in jobs:
            route(job)
    else:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            list(pool.map(route, jobs))
    return [list(zip(dists, mk)) for mk in masks]


def _benes_stages(perm2d: np.ndarray) -> List[Tuple[int, np.ndarray]]:
    """Beneš switch masks for one batch of permutations."""
    return _benes_stages_many([perm2d])[0]


# ---------------------------------------------------------------------------
# gather network = Beneš + run broadcast + Beneš
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GatherPlanHost:
    """Host-side stage schedule for a batch of same-size gather networks.

    kinds[s]: 'xor' (partner i^d), 'shift' (source i-d, cyclic roll), or
              'shiftl' (source i+d — monotone concentrate phases)
    dists[s]: power-of-two distance
    masks:    [S, B, m] bool
    m:        network size (power of two); out slot k of net b computes
              x_b[idx[b, k]] for k < idx.shape[1], don't-care beyond.
    """

    kinds: Tuple[str, ...]
    dists: Tuple[int, ...]
    masks: np.ndarray
    m: int

    def apply_host(self, x: np.ndarray) -> np.ndarray:
        """Reference applier: x [B, m] -> routed [B, m]."""
        y = np.asarray(x).copy()
        if y.ndim == 1:
            y = y[None]
        B, m = y.shape
        rows = np.arange(B)[:, None]
        e = np.arange(m)[None, :]
        for kind, d, mask in zip(self.kinds, self.dists, self.masks):
            if kind == "xor":
                src = e ^ d
            elif kind == "shiftl":
                src = (e + d) % m
            else:
                src = (e - d) % m
            y = np.where(mask, y[rows, np.broadcast_to(src, (B, m))], y)
        return y


def _monotone_stages(
    sidx: np.ndarray, is_first: np.ndarray, m: int
) -> List[Tuple[str, int, np.ndarray]]:
    """Phases 1+2 as monotone shift networks (see build_gather_network).

    Replaces [Beneš perm1 + run broadcast] with:

      A. concentrate (kind 'shiftl', LSB-first): used value u_r moves
         from slot u_r left to its rank slot r. The shift distances
         δA_r = u_r − r (= #unused values below u_r) are non-decreasing
         in r, so processing the bits of δA least-significant-first is
         collision-free: a mid-flight collision at stage j would need
         (δ2 mod 2^(j+1)) − (δ1 mod 2^(j+1)) = u2 − u1 > δ2 − δ1, i.e.
         the mod difference to exceed the true difference, which forces a
         wrap of −2^(j+1) on the smaller — impossible for δ2 ≥ δ1.

      B. interval multicast (kind 'shift', MSB-first): sorted output
         position p copies rank slot r(p)'s value, δB_p = p − r(p)
         non-decreasing. Processing bits most-significant-first keeps the
         invariant "after bits ≥ b, the value for output p sits at
         r(p) + hi_b(δB_p)" (hi_b = δ with bits < b cleared): positions
         of distinct ranks never collide at any level because hi_b is
         monotone in δ, and outputs sharing a rank share the value, so
         copies are coherent. This single phase realizes the spread AND
         the run broadcast — the separate broadcast phase disappears.

    Stage counts: ceil(log2(max δA + 1)) + ceil(log2(max δB + 1)), vs
    Beneš' fixed 2·log2(m) − 1 + log2(max run). The win grows with value
    coverage (δA → 0 when every value is used — callers fill don't-care
    pad slots with missing values for exactly this reason).
    """
    B, T = sidx.shape
    stages: List[Tuple[str, int, np.ndarray]] = []
    if T == 0:
        return stages
    rank_of_pos = np.cumsum(is_first, axis=1) - 1  # [B, T] run index r(p)

    # ---- phase A: concentrate used values to rank slots
    b_f, p_f = np.nonzero(is_first)
    u = sidx[b_f, p_f]
    r = rank_of_pos[b_f, p_f]
    dA = u - r
    assert (dA >= 0).all()
    maxA = int(dA.max()) if len(dA) else 0
    j = 0
    while (1 << j) <= maxA:
        sel = (dA >> j) & 1 == 1
        dest = u[sel] - (dA[sel] & ((2 << j) - 1))
        mask = np.zeros((B, m), dtype=bool)
        mask[b_f[sel], dest] = True
        stages.append(("shiftl", 1 << j, mask))
        j += 1

    # ---- phase B: monotone interval multicast rank slot -> run interval
    dB = np.arange(T)[None, :] - rank_of_pos  # [B, T] >= 0
    maxB = int(dB.max())
    nb = maxB.bit_length()
    for bbit in range(nb - 1, -1, -1):
        sel = ((dB >> bbit) & 1) == 1
        bsel, psel = np.nonzero(sel)
        dest = rank_of_pos[bsel, psel] + (
            (dB[bsel, psel] >> bbit) << bbit
        )
        mask = np.zeros((B, m), dtype=bool)
        mask[bsel, dest] = True
        stages.append(("shift", 1 << bbit, mask))
    return stages


def build_gather_network(
    idx: np.ndarray, n: int, m: int | None = None, *, drop_empty: bool = True,
    mode: str = "benes",
) -> GatherPlanHost:
    """Build routing networks computing out[b, k] = x[b, idx[b, k]].

    idx: [B, T] int (0 <= idx < n); m: network size (power of two,
    >= max(n, T); default = that bound). Stages with all-false masks are
    dropped (common when idx is partially sorted) unless drop_empty=False
    (hierarchical nets keep the canonical schedule so every net shares
    the same pass structure).

    mode: 'benes' = Beneš perm1 + run broadcast (any stage distance
    profile; the right choice for hierarchical nets, whose XOR stages
    group into cheap butterfly passes); 'monotone' = concentrate +
    interval-multicast shift phases (_monotone_stages) — fewer stages
    (the whole broadcast phase folds away), best for single-table nets
    where every stage costs the same. Both end with the same Beneš
    perm2 to the requested slot order.
    """
    assert mode in ("benes", "monotone"), f"unknown net mode {mode!r}"
    idx = np.asarray(idx, dtype=np.int64)
    if idx.ndim == 1:
        idx = idx[None]
    B, T = idx.shape
    need = max(n, T, 2)
    if m is None:
        m = 1 << int(np.ceil(np.log2(need)))
    assert m >= need and m & (m - 1) == 0
    rows = np.arange(B)[:, None]

    ordv = np.argsort(idx, axis=1, kind="stable")
    sidx = np.take_along_axis(idx, ordv, axis=1)

    # run starts in sorted order
    is_first = np.ones((B, T), dtype=bool)
    is_first[:, 1:] = sidx[:, 1:] != sidx[:, :-1]

    stages1: List[Tuple[int, np.ndarray]] = []
    bcast: List[Tuple[int, np.ndarray]] = []
    mono: List[Tuple[str, int, np.ndarray]] = []
    if mode == "monotone":
        mono = _monotone_stages(sidx, is_first, m)
    else:
        # ---- permutation 1: value v (slot v) -> first position of its run
        perm1 = np.full((B, m), -1, dtype=np.int64)
        firsts = np.nonzero(is_first)  # (b_list, p_list) sorted by (b, p)
        perm1[firsts[0], sidx[firsts[0], firsts[1]]] = firsts[1]
        # fill unassigned sources with unassigned targets, in order (keeps
        # the filler near-monotone -> fewer set switches)
        unassigned_src = perm1 < 0
        tgt_taken = np.zeros((B, m), dtype=bool)
        tgt_taken[firsts[0], firsts[1]] = True
        for b in range(B):
            src = np.nonzero(unassigned_src[b])[0]
            tgt = np.nonzero(~tgt_taken[b])[0]
            perm1[b, src] = tgt

        # ---- broadcast: offset within run, copy from k - 2^msb(o)
        run_first = np.maximum.accumulate(
            np.where(is_first, np.arange(T)[None, :], 0), axis=1
        )
        off = np.arange(T)[None, :] - run_first
        max_off = int(off.max()) if T else 0
        j = 0
        while (1 << j) <= max_off:
            d = 1 << j
            sel = (off >> j) == 1  # msb(off) == j <=> off in [2^j, 2^(j+1))
            mask = np.zeros((B, m), dtype=bool)
            mask[:, :T] = sel
            bcast.append((d, mask))
            j += 1

    # ---- permutation 2: sorted position p -> requested slot ord[p]
    perm2 = np.broadcast_to(np.arange(m), (B, m)).copy()
    perm2[:, :T] = ordv
    if T < m:
        # positions T..m carry don't-care values; ordv values < T so the
        # tail identity mapping keeps perm2 a permutation
        pass
    if mode == "benes":
        stages1, stages2 = _benes_stages_many([perm1, perm2])
    else:
        stages2 = _benes_stages(perm2)

    kinds: List[str] = []
    dists: List[int] = []
    masks: List[np.ndarray] = []
    for k, d, mk in mono:
        kinds.append(k); dists.append(d); masks.append(mk)
    for d, mk in stages1:
        kinds.append("xor"); dists.append(d); masks.append(mk)
    for d, mk in bcast:
        kinds.append("shift"); dists.append(d); masks.append(mk)
    for d, mk in stages2:
        kinds.append("xor"); dists.append(d); masks.append(mk)

    keep = [s for s, mk in enumerate(masks) if (not drop_empty) or mk.any()]
    return GatherPlanHost(
        kinds=tuple(kinds[s] for s in keep),
        dists=tuple(dists[s] for s in keep),
        masks=np.stack([masks[s] for s in keep]) if keep else np.zeros((0, B, m), bool),
        m=m,
    )
