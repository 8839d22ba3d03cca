"""The pass schedule of the single-table kernels (K1 routed_apply, K11
routed_apply_t) and the locality the CUDA kernels rely on, on the CPU.

routed_passes cuts a network's stages into low, high and stage passes; the
kernels of csrc/tile_pass.cuh run each tile pass with only its tile (and
halo) in shared memory. `_emulate` below runs a schedule the same way, tile
by tile, each tile seeing only its own slots and halo, and poisons (NaN)
every slot a stage leaves outside the range it computes: it must equal the
plain versions and the Pallas kernels (interpret mode) bit for bit, also
for a df64 pair with compensated merges and signed zeros. Random masks on
the networks' own schedules switch halo slots and cyclic wrap-around,
which a real network seldom does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lilac_tpu.kernels import routed as jrd
from lilac_tpu_torch.kernels import routed as trd
from lilac_tpu_torch.kernels import routenet as trn

torch.set_num_threads(1)


def _net(m, mode, B=2, seed=1):
    ncol = m - m // 4
    idx = np.random.default_rng(seed).integers(0, ncol, size=(B, m))
    return idx, trn.build_gather_network(idx, ncol, m, mode=mode)


def _random_masks(rng, B, S, m):
    packed = rng.integers(0, 256, size=(B, (S + 7) // 8, m // 128, 128), dtype=np.uint8)
    return torch.as_tensor(packed.view(np.int8))


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32 if x.element_size() == 4 else torch.int64)


def _bits_equal(a, b) -> bool:
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _planes(rng, fmt, shape):
    """Value planes in a format: f32 / f64 one plane, f32 two planes, or a
    df64 (hi, lo) pair with a few signed zeros."""
    dtype = np.float64 if fmt == "f64" else np.float32
    n = int(np.prod(shape))
    hi = rng.standard_normal(n).astype(dtype).reshape(shape)
    hi[rng.random(shape) < 0.02] = -0.0
    xs = [hi]
    if fmt == "f32x2":
        xs.append(rng.standard_normal(n).astype(dtype).reshape(shape))
    elif fmt == "df":
        xs.append((hi * dtype(2.0 ** -25)).astype(dtype))
    return [torch.as_tensor(x) for x in xs]


# ---- (a) the schedule ------------------------------------------------------


def _check_schedule(kinds, dists, m, tile):
    passes = trd.routed_passes(tuple(kinds), tuple(dists), m, tile)
    t = min(tile, m)
    covered = []
    for kind, a, b in passes:
        assert kind in trd.PASS_KINDS and a < b
        covered += list(range(a, b))
        ks, ds = kinds[a:b], dists[a:b]
        if kind == "stage":
            assert b - a == 1 and ds[0] >= t and m > t * t // 4
        elif kind == "high":
            assert t < m <= t * t // 4 and b - a <= trd.MAX_PASS_STAGES
            assert all(d >= t and d % t == 0 for d in ds)
        elif set(ks) == {"xor"}:
            assert all(d < t for d in ds) and b - a <= trd.MAX_PASS_STAGES
        else:
            assert "xor" not in ks and b - a <= trd.MAX_HALO_STAGES
            left = sum(d for k, d in zip(ks, ds) if k == "shift")
            right = sum(d for k, d in zip(ks, ds) if k == "shiftl")
            assert all(d < t for d in ds)
            assert (left + 3) // 4 * 4 + (right + 3) // 4 * 4 <= t
    assert covered == list(range(len(kinds)))
    return passes


@pytest.mark.parametrize("mode", ["monotone", "benes"])
@pytest.mark.parametrize("log2m", [10, 12, 14, 16, 18])
def test_routed_passes_cover_every_stage_locally(mode, log2m):
    """Every stage once, in order, each pass local to its tile kind, at
    tiles from 2^7 (T^2/4 < m from 2^13 up: stage passes) to 2^14."""
    m = 1 << log2m
    _, net = _net(m, mode, B=1)
    seen = set()
    for tile in (128, 512, 2048, 8192, 16384):
        passes = _check_schedule(net.kinds, net.dists, m, tile)
        seen |= {p[0] for p in passes}
    assert "low" in seen
    if m >= 1 << 15:
        assert {"high", "stage"} <= seen


def test_routed_passes_class_c_shape():
    """NPB class C's monotone schedule (m = 2^18) in 6 passes at the df64
    tile 2^13, the same order of kinds at 2^12 and 2^14; the schedule is
    cached on its arguments."""
    m = 1 << 18
    kinds = ("shiftl",) * 15 + ("shift",) * 18 + ("xor",) * 35
    dists = (tuple(1 << b for b in range(15)) + tuple(1 << b for b in range(17, -1, -1))
             + tuple(1 << b for b in range(17, -1, -1))
             + tuple(1 << b for b in range(1, 18)))
    for tile in (1 << 12, 1 << 13, 1 << 14):
        passes = _check_schedule(kinds, dists, m, tile)
        assert [p[0] for p in passes] == ["low", "high", "low", "high", "low", "high"]
    assert trd.routed_passes(kinds, dists, m, 1 << 13) is trd.routed_passes(
        kinds, dists, m, 1 << 13)


def test_routed_tile_from_shared_memory():
    """T from the opt-in limit for the word width and plane count; the
    worst pass of the next tile up would not fit."""
    limit = trd.HOPPER_SMEM_OPTIN
    for nplanes, esize, want in ((2, 4, 1 << 13), (1, 4, 1 << 14), (2, 8, 1 << 12),
                                 (1, 8, 1 << 13)):
        tile = trd.routed_tile(nplanes, esize, limit)
        assert tile == want
        assert trd.routed_tile_smem(tile, nplanes, esize) <= limit
        assert trd.routed_tile_smem(2 * tile, nplanes, esize) > limit


# ---- (b) tile-by-tile emulation --------------------------------------------


def _stage_plain(ys, bits, s, kind, d, m, adjoint, dfpair):
    """One stage over the whole table (a `stage` pass)."""
    idx = torch.arange(m)
    mask = ((bits[:, s // 8] >> (s % 8)) & 1) != 0
    if adjoint:
        return trd._stage_adj_plain(ys, mask, kind, d, idx, dfpair)
    src = idx ^ d if kind == "xor" else (idx - d) % m if kind == "shift" else (idx + d) % m
    return [torch.where(mask, y[:, src], y) for y in ys]


def _emulate(x_planes, masks, kinds, dists, tile, *, adjoint=False, dfpair=False):
    """The schedule of routed_passes run tile by tile: every tile of a pass
    is gathered with its halo, the pass's stages run on the tile alone
    (partners in tile coordinates, as the kernels compute them), each stage
    only over the range the later stages read, the rest set to NaN, and
    only the tile is written back."""
    B, P, R, _ = masks.shape
    m = R * 128
    bits = masks.reshape(B, P, m).to(torch.int32)
    if adjoint:
        ys = [x.reshape(B, m).clone() for x in x_planes]
    else:
        ys = [x.reshape(1, m).expand(B, m).clone() for x in x_planes]
    passes = trd.routed_passes(tuple(kinds), tuple(dists), m, tile)
    t = min(tile, m)
    for kind, a, b in (reversed(passes) if adjoint else passes):
        run = list(range(b - 1, a - 1, -1) if adjoint else range(a, b))
        if kind == "stage":
            (s,) = run
            ys = _stage_plain(ys, bits, s, kinds[s], dists[s], m, adjoint, dfpair)
            continue
        ntiles = m // t
        if kind == "high":
            H = m // t
            C = t // H
            w = torch.arange(t)
            h, c = w // C, w % C
            gidx = h[None] * t + torch.arange(ntiles)[:, None] * C + c[None]
            dl, W = 0, t
        else:
            # a shift reads w - d forwards, w + d in the adjoint; shiftl the other way
            shifts = [s for s in run if kinds[s] != "xor"]
            down = [s for s in shifts if (kinds[s] == "shift") != adjoint]
            up = [s for s in shifts if s not in down]
            dl = (sum(dists[s] for s in down) + 3) // 4 * 4
            dr = (sum(dists[s] for s in up) + 3) // 4 * 4
            W = t + dl + dr
            gidx = (torch.arange(ntiles)[:, None] * t - dl + torch.arange(W)[None]) % m
        # the range each stage computes: what the stages after it still read
        lo, hi, ranges = dl, dl + t, {}
        for s in reversed(run):
            ranges[s] = (lo, hi) if kinds[s] != "xor" and kind == "low" else (0, W)
            if kind == "low" and kinds[s] != "xor":
                if (kinds[s] == "shift") != adjoint:
                    lo -= dists[s]
                else:
                    hi += dists[s]
        assert lo >= 0 and hi <= W
        win = [y[:, gidx] for y in ys]  # [B, tiles, W]
        pos = torch.arange(W)
        for s in run:
            k, d = kinds[s], dists[s]
            mask = ((bits[:, s // 8][:, gidx] >> (s % 8)) & 1) != 0
            if kind == "high":
                rows = d // t
                hrow, col = pos // C, pos % C
                if k == "xor":
                    part = pos ^ (rows * C)
                else:
                    step = rows if (k == "shiftl") != adjoint else -rows
                    part = ((hrow + step) % H) * C + col
            elif k == "xor":
                part = pos ^ d
            else:
                part = pos + d if (k == "shiftl") != adjoint else pos - d
            r0, r1 = ranges[s]
            inside = (pos >= r0) & (pos < r1)
            assert bool(((part[inside] >= 0) & (part[inside] < W)).all())
            part = part.clamp(0, W - 1)
            if adjoint and k != "xor":
                zero = win[0].new_zeros(())
                kept = [torch.where(mask, zero, y) for y in win]
                moved = [torch.where(mask[..., part], y[..., part], zero) for y in win]
                new = trd._merge_adj(kept, moved, dfpair)
            else:
                new = [torch.where(mask, y[..., part], y) for y in win]
            nan = win[0].new_full((), float("nan"))
            win = [torch.where(inside, y, nan) for y in new]
        out = gidx[:, dl:dl + t]
        for y, wv in zip(ys, win):
            y[:, out] = wv[..., dl:dl + t]
    return tuple(y.reshape(B, R, 128) for y in ys)


@pytest.mark.parametrize("mode", ["monotone", "benes"])
@pytest.mark.parametrize("tile", [128, 256, 1024, 4096])
def test_emulation_equals_plain_forward(mode, tile):
    """K1's schedule tile by tile == routed_apply_plain bit for bit, on the
    network's masks (== x[idx]) and on random masks, at m = 2^14 (tile 128:
    stage passes; 256, 1024: high passes with C = 4 and 64; 4096)."""
    m = 1 << 14
    idx, net = _net(m, mode)
    rng = np.random.default_rng(tile)
    for masks in (trd.masks_device(net, "cpu"), _random_masks(rng, 2, len(net.kinds), m)):
        for fmt in ("f32", "f32x2", "f64"):
            xs = [x.view(m // 128, 128) for x in _planes(rng, fmt, (m,))]
            got = _emulate(xs, masks, net.kinds, net.dists, tile)
            want = trd.routed_apply_plain(xs, masks, net.kinds, net.dists)
            assert all(_bits_equal(g, w) for g, w in zip(got, want))
    x = torch.as_tensor(rng.standard_normal(m))
    (out,) = _emulate([x.view(m // 128, 128)], trd.masks_device(net, "cpu"),
                      net.kinds, net.dists, tile)
    assert torch.equal(out.reshape(2, m), x[torch.as_tensor(idx)])


@pytest.mark.parametrize("mode", ["monotone", "benes"])
@pytest.mark.parametrize("tile", [128, 512, 4096])
@pytest.mark.parametrize("fmt", ["f32", "f32x2", "df", "f64"])
def test_emulation_equals_plain_adjoint(mode, tile, fmt):
    """K11's schedule tile by tile (passes last to first, stages backwards,
    halos on the other side) == routed_apply_t_plain bit for bit, on random
    masks over the network's schedule at m = 2^14."""
    m = 1 << 14
    _, net = _net(m, mode)
    rng = np.random.default_rng(100 + tile)
    masks = _random_masks(rng, 2, len(net.kinds), m)
    xs = _planes(rng, fmt, (2, m // 128, 128))
    dfpair = fmt == "df"
    got = _emulate(xs, masks, net.kinds, net.dists, tile, adjoint=True, dfpair=dfpair)
    want = trd.routed_apply_t_plain(xs, masks, net.kinds, net.dists, dfpair=dfpair)
    assert all(_bits_equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("mode", ["monotone", "benes"])
def test_emulation_equals_pallas_interpret(mode):
    """At m = 2^12 with tiles 32 and 64 (low and stage passes), 128 (high,
    4 slots a row) and 4096 (low only): the emulation == the JAX
    package's routed_apply / routed_apply_t in interpret mode, bit for bit
    (f32 pair forwards, df64 pair in reverse)."""
    m, B = 1 << 12, 2
    _, net = _net(m, mode, B=B, seed=5)
    rng = np.random.default_rng(6)
    masks = _random_masks(rng, B, len(net.kinds), m)
    xs = _planes(rng, "f32x2", (m,))
    want = jrd.routed_apply([jnp.asarray(x.numpy().reshape(m // 128, 128)) for x in xs],
                            jnp.asarray(masks.numpy()), net.kinds, net.dists,
                            interpret=True)
    us = _planes(rng, "df", (B, m // 128, 128))
    want_t = jrd.routed_apply_t([jnp.asarray(u.numpy()) for u in us],
                                jnp.asarray(masks.numpy()), net.kinds, net.dists,
                                dfpair=True, interpret=True)
    kinds_seen = set()
    for tile in (32, 64, 128, 4096):
        kinds_seen |= {p[0] for p in trd.routed_passes(net.kinds, net.dists, m, tile)}
        got = _emulate([x.view(m // 128, 128) for x in xs], masks, net.kinds,
                       net.dists, tile)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(np.asarray(w).view(np.int32),
                                          g.numpy().view(np.int32))
        got_t = _emulate(us, masks, net.kinds, net.dists, tile, adjoint=True,
                         dfpair=True)
        for w, g in zip(want_t, got_t):
            np.testing.assert_array_equal(np.asarray(w).view(np.int32),
                                          g.numpy().view(np.int32))
    assert kinds_seen == set(trd.PASS_KINDS)


# ---- (c) the wrappers' tile argument ---------------------------------------


@pytest.mark.parametrize("fn", ["routed_apply", "routed_apply_t"])
def test_wrappers_reject_a_tile_that_does_not_fit(fn):
    """A tile that is not a power of two >= 128, or whose worst pass does
    not fit the shared memory for the planes' width, raises on any device;
    one that fits takes the plain version on the CPU."""
    m, B = 2048, 2
    _, net = _net(m, "monotone", B=B)
    masks = trd.masks_device(net, "cpu")
    lead = (B,) if fn == "routed_apply_t" else ()
    call = getattr(trd, fn)
    pair = [torch.zeros(lead + (m // 128, 128)) for _ in range(2)]
    one = pair[:1]
    f64 = [torch.zeros(lead + (m // 128, 128), dtype=torch.float64)] * 2
    for planes, bad in ((pair, 100), (pair, 64), (pair, 1 << 14), (one, 1 << 15),
                        (f64, 1 << 13), (one, 0)):
        with pytest.raises(ValueError):
            call(planes, masks, net.kinds, net.dists, tile=bad)
    for planes, good in ((pair, 1 << 13), (one, 1 << 14), (f64, 1 << 12), (pair, 128)):
        want = call(planes, masks, net.kinds, net.dists)
        got = call(planes, masks, net.kinds, net.dists, tile=good)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert call.launches == 0 and call.stage_launches == 0
