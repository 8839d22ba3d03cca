"""The window-pass adjoint (K9 window_shift_apply_bt) as the CUDA kernel of
csrc/adjoint.cu partitions it, on the CPU.

The kernel cuts each window block of bl output slots into bl / C thread
blocks of C slots (the span, window_bt_span). A thread block stages window
slots [c0, c0 + C + sum(d)) of the (self, right) window and their mask
bytes, then runs the stages last to first between two buffers: stage s
reads one buffer and writes slots [0, C + d[0] + .. + d[s-1]) of the other.
`_emulate` below does the same with numpy, every slot a stage did not write
poisoned with a NaN and every read checked inside what was staged or
written; it must equal window_shift_apply_bt_plain bit for bit (signed
zeros and the lo words of a df64 pair included) at every span, and the
plain version must equal the Pallas kernel in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lilac_tpu.kernels import routed as jrd
from lilac_tpu_torch.kernels import routed as trd
from lilac_tpu_torch.kernels import routenet as trn
from lilac_tpu_torch.ops import dfloat as tdf

torch.set_num_threads(1)

NB = 8  # window blocks a net

# word format: (numpy dtype, planes, dfpair)
_FORMATS = {"f32": (np.float32, 1, False), "f32x2": (np.float32, 2, False),
            "df64": (np.float32, 2, True), "f64": (np.float64, 1, False)}
_POISON = {np.float32: np.uint32(0x7FC0BEEF), np.float64: np.uint64(0x7FF80000DEADBEEF)}


def _planes(rng, fmt, shape):
    """Planes of one format with signed zeros among the values; a df64 pair
    has its lo word well below hi's last bit."""
    dtype, nplanes, dfpair = _FORMATS[fmt]
    v = rng.standard_normal((nplanes,) + shape) * np.exp(rng.uniform(-6, 6, (nplanes,) + shape))
    v[rng.random(v.shape) < 0.05] = -0.0
    if dfpair:
        s = tdf.split_f64_np(v[0])
        return [np.ascontiguousarray(s[..., 0]), np.ascontiguousarray(s[..., 1])]
    return [p.astype(dtype) for p in v]


def _phys(b, layout):
    return sum(((b >> src) & 1) << k for k, src in enumerate(layout))


def _merge(kept, moved, dfpair):
    """The kernel's merge (tile_pass.cuh:merge) in numpy: every op rounded on
    its own."""
    if dfpair:
        s = kept[0] + moved[0]
        bb = s - kept[0]
        e = (kept[0] - (s - bb)) + (moved[0] - bb)
        low = e + (kept[1] + moved[1])
        hi = s + low
        return [hi, low - (hi - s)]
    return [k + m for k, m in zip(kept, moved)]


def _emulate(xs, masks, dists, bl, span, dfpair, layout=None):
    """The kernel's thread blocks in numpy, all at once. xs: per-net planes
    [N, mrows, 128]; masks [N, nblocks, 2R, 128] int8. Returns [N, mrows,
    128] planes."""
    N, nblocks = masks.shape[:2]
    nplanes, dtype = len(xs), xs[0].dtype
    layout = tuple(range(nblocks.bit_length() - 1)) if layout is None else layout
    sumd = sum(dists)
    reach = span + sumd
    Wv, Wm = (reach + 3) & ~3, (reach + 31) & ~31
    assert trd.window_bt_smem_bytes(span, dists, nplanes, dtype.itemsize) == (
        2 * nplanes * dtype.itemsize * Wv + Wm)
    # window position w = c0 + i of every thread block (n, b, c0)
    b = np.arange(nblocks).reshape(nblocks, 1, 1)
    c0 = (np.arange(bl // span) * span).reshape(1, -1, 1)
    phys = np.array([_phys(v, layout) for v in range(nblocks)])
    right = (b + 1) % nblocks

    def staged(width):
        w = c0 + np.arange(width)
        assert w.max() < 2 * bl  # never past the right block
        return w, np.where(w < bl, phys[b] * bl + w, phys[right] * bl + (w - bl))

    w, src = staged(Wv)
    flat = [x.reshape(N, nblocks * bl) for x in xs]
    bufs = [[f[:, src] for f in flat],
            [np.full(f[:, src].shape, _POISON[dtype.type]).view(dtype) for f in flat]]
    w, _ = staged(Wm)
    own = masks.reshape(N, nblocks, 2 * bl).view(np.uint8)[..., bl:]  # self halves
    mk = np.where(w < bl, own[:, b, np.minimum(w, bl - 1)],
                  own[:, right, np.maximum(w - bl, 0)]).astype(np.int32)
    cur = 0
    for s in range(len(dists) - 1, -1, -1):
        d, lim = dists[s], span + sum(dists[:s])
        i = np.arange(lim)
        assert lim + d <= reach <= Wv <= Wm  # reads stay inside the staged slots
        u, v = bufs[cur], bufs[cur ^ 1]
        mi = ((mk[..., i] >> s) & 1) != 0
        mj = ((mk[..., i + d] >> s) & 1) != 0
        kept = [np.where(mi, dtype.type(0), p[..., i]) for p in u]
        moved = [np.where(mj, p[..., i + d], dtype.type(0)) for p in u]
        for p, o in zip(v, _merge(kept, moved, dfpair)):
            p[..., :lim] = o
            p[..., lim:] = np.array(_POISON[dtype.type]).view(dtype)  # stale
        cur ^= 1
    return [np.ascontiguousarray(p[..., :span]).reshape(N, nblocks * bl // 128, 128)
            for p in bufs[cur]]


def _shift_sets(bl):
    """No shift, one shift, class D's four (reversed as the plan holds them),
    the general matrix's eight (sum 255), one shift of bl - 1 and eight that
    sum to bl - 1."""
    top = [bl >> j for j in range(1, 8)]
    return [(), (1,), (8, 4, 2, 1), tuple(1 << j for j in range(8)), (bl - 1,),
            tuple(top + [bl - 1 - sum(top)])]


def _random_masks(rng, N, bl):
    return rng.integers(0, 256, size=(N, NB, 2 * bl // 128, 128),
                        dtype=np.uint8).view(np.int8)


def _network_windows(seed, N, bl):
    """Window passes of real networks: Benes gather networks over NB blocks
    of bl slots, split by compile_hier; one dense column per net, so that
    broadcast runs reach across blocks. Returns [(dists, masks [N, NB, 2R,
    128])] for every window pass the N nets share."""
    rng = np.random.default_rng(seed)
    m = NB * bl
    idx = rng.integers(0, m - 100, size=(N, m))
    for n in range(N):
        idx[n, rng.choice(m, size=m // 16, replace=False)] = 5 + n
    net = trn.build_gather_network(idx, m - 100, m, drop_empty=False)
    per_net = [trd.compile_hier(net.kinds, net.dists, net.masks[:, n, :], bl)
               for n in range(N)]
    out = []
    for j, p in enumerate(per_net[0]):
        if p[0] == "window":
            out.append((p[1], np.stack([per_net[n][j][-1] for n in range(N)])))
    assert out
    return out


@pytest.mark.parametrize("fmt", list(_FORMATS))
@pytest.mark.parametrize("bl", [256, 512, 1024])
def test_partition_emulation_matches_plain_random_masks(bl, fmt):
    """Every span the kernel takes at this bl, every shift set (sum(d) up to
    bl - 1), random masks (so the last block's window wraps to block 0),
    identity and scrambled layouts, one and three nets."""
    dtype, nplanes, dfpair = _FORMATS[fmt]
    rng = np.random.default_rng(bl + len(fmt))
    spans = [c for c in (128, 256, 512, 1024) if c <= bl]
    for j, (span, dists) in enumerate((c, d) for c in spans for d in _shift_sets(bl)):
        N = 3 if j % 2 else 1
        layout = (2, 0, 1) if j % 3 else None
        masks = _random_masks(rng, N, bl)
        xs = _planes(rng, fmt, (N, NB * bl // 128, 128))
        got = _emulate(xs, masks, dists, bl, span, dfpair, layout)
        want = trd.window_shift_apply_bt_plain(
            [torch.as_tensor(x) for x in xs], torch.as_tensor(masks), dists, bl,
            dfpair=dfpair, layout=layout)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.view(np.uint8), w.numpy().view(np.uint8))


@pytest.mark.parametrize("fmt", ["df64", "f64"])
@pytest.mark.parametrize("bl", [256, 1024])
def test_partition_emulation_matches_plain_network_masks(bl, fmt):
    """The window passes compile_hier builds from gather networks, at every
    span, scrambled layout."""
    dtype, nplanes, dfpair = _FORMATS[fmt]
    rng = np.random.default_rng(7 * bl)
    for dists, masks in _network_windows(bl, 2, bl):
        xs = _planes(rng, fmt, (2, NB * bl // 128, 128))
        want = trd.window_shift_apply_bt_plain(
            [torch.as_tensor(x) for x in xs], torch.as_tensor(masks), dists, bl,
            dfpair=dfpair, layout=(1, 2, 0))
        for span in (c for c in (128, 256, 512, 1024) if c <= bl):
            got = _emulate(xs, masks, dists, bl, span, dfpair, (1, 2, 0))
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.view(np.uint8), w.numpy().view(np.uint8))


@pytest.mark.parametrize("bl", [256, 1024, 8192, 16384])
def test_window_bt_span_rule(bl):
    """A power of two from 128 to bl; the smallest from WINDOW_BT_MIN_SPAN
    whose halo sum(d) is at most a quarter of it, else bl, halved only where
    its two buffers would not fit; cached; within the device's shared memory
    wherever the plan's window budget is."""
    limit = trd.HOPPER_SMEM_OPTIN
    for dists in [(), (1,), (8, 4, 2, 1), tuple(1 << j for j in range(8)),
                  (bl // 8,), (bl // 4 - 1,), (bl // 4 + 1,), (bl - 1,)]:
        sumd = sum(dists)
        for nplanes, esize in ((1, 4), (2, 4), (1, 8)):
            span = trd.window_bt_span(bl, dists, nplanes, esize)
            assert trd.window_bt_span(bl, dists, nplanes, esize) == span
            assert 128 <= span <= bl and span & (span - 1) == 0
            fits = trd.window_bt_smem_bytes(span, dists, nplanes, esize) <= limit
            assert fits or trd.pass_smem_bytes(("window", dists), bl, nplanes, esize) > limit
            if span > min(trd.WINDOW_BT_MIN_SPAN, bl):  # half would break the halo rule
                assert 8 * sumd > span
            if 4 * sumd > span:  # the halo rule broken: bl, or what fits
                assert span == bl or trd.window_bt_smem_bytes(
                    2 * span, dists, nplanes, esize) > limit
        if 4 * sumd > bl and bl <= 1024:
            assert trd.window_bt_span(bl, dists) == bl  # the fallback to bl
    # the main paths' shapes: class D (sum 15) and the general matrix (255)
    if bl == 8192:
        assert trd.window_bt_span(bl, (8, 4, 2, 1), 2, 4) == 512
        assert trd.window_bt_span(bl, tuple(1 << j for j in range(8)), 2, 4) == 1024
        cfg = trd.window_bt_launch_config(bl, (8, 4, 2, 1), 2, 4, N=16, nblocks=256)
        assert cfg == {"grid": [256, 16], "threads": 128, "span": 512,
                       "spans_per_block": 16, "smem_bytes": 3 * 2 * 4 * 528 + 2 * 544}
    # spans a thread block takes in turn: up to WINDOW_BT_SPANS where two input
    # slots fit, one where they do not
    assert trd.window_bt_spans(bl, bl, (1,), 2, 4) == 1
    assert trd.window_bt_spans(bl, 128, (1,), 2, 4) == min(bl // 128, trd.WINDOW_BT_SPANS)
    assert trd.window_bt_spans(bl, 128, (bl - 1,), 2, 8, limit=trd.window_bt_smem_bytes(
        128, (bl - 1,), 2, 8)) == 1


@pytest.mark.parametrize("bl", [256, 8192])
def test_window_bt_fits_every_feasible_window(bl):
    """Span 128 fits wherever check_smem_feasible admits the window pass, so
    the rule never leaves a feasible plan without a span that runs."""
    for nplanes, esize in ((1, 4), (2, 4), (1, 8), (2, 8)):
        for sumd in (0, 15, 255, bl // 2, bl - 1):
            dists = (sumd,) if sumd else ()
            try:
                trd.check_smem_feasible((("window", dists),), bl, nplanes, esize)
            except ValueError:
                continue
            assert trd.window_bt_smem_bytes(128, dists, nplanes, esize) <= trd.HOPPER_SMEM_OPTIN
            span = trd.window_bt_span(bl, dists, nplanes, esize)
            assert trd.window_bt_smem_bytes(span, dists, nplanes, esize) <= trd.HOPPER_SMEM_OPTIN


@pytest.mark.parametrize("fmt", ["f32", "df64", "f64"])
def test_plain_matches_pallas_interpret(fmt):
    """The plain version (and the wrapper, which takes it for CPU tensors)
    against the Pallas adjoint in interpret mode, power-of-two shifts (the
    Pallas window pass is exact for those), scrambled layout, the last
    block wrapping to block 0."""
    dtype, nplanes, dfpair = _FORMATS[fmt]
    bl = 256
    rng = np.random.default_rng(11)
    masks = _random_masks(rng, 2, bl)
    xs = _planes(rng, fmt, (2, NB * bl // 128, 128))
    for dists in ((8, 4, 2, 1), (1, 2, 4, 8, 16, 32, 64)):
        want = jrd.window_shift_apply_bt([jnp.asarray(x) for x in xs], jnp.asarray(masks),
                                         dists, bl, dfpair=dfpair, layout=(2, 0, 1),
                                         interpret=True)
        for fn in (trd.window_shift_apply_bt, trd.window_shift_apply_bt_plain):
            got = fn([torch.as_tensor(x) for x in xs], torch.as_tensor(masks), dists, bl,
                     dfpair=dfpair, layout=(2, 0, 1))
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy().view(np.uint8),
                                              np.asarray(w).view(np.uint8))


def test_wrapper_rejects_bad_span_and_unaligned_masks():
    """On the CPU path too: a span that is not a power of two from 128 to bl,
    and masks that do not start on a 16-byte boundary (the kernel stages them
    with 16-byte copies)."""
    bl = 256
    rng = np.random.default_rng(3)
    masks = torch.as_tensor(_random_masks(rng, 1, bl))
    xs = [torch.as_tensor(x) for x in _planes(rng, "f32", (1, NB * bl // 128, 128))]
    for span in (64, 192, 512):
        with pytest.raises(ValueError, match="span"):
            trd.window_shift_apply_bt(xs, masks, (1, 2), bl, span=span)
    got = trd.window_shift_apply_bt(xs, masks, (1, 2), bl, span=256)
    want = trd.window_shift_apply_bt_plain(xs, masks, (1, 2), bl)
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    buf = torch.zeros(masks.numel() + 16, dtype=torch.int8)
    off = (16 - buf.data_ptr() % 16) % 16 + 1  # one byte past a 16-byte boundary
    shifted = buf[off:off + masks.numel()].view(masks.shape)
    shifted.copy_(masks)
    with pytest.raises(ValueError, match="16-byte aligned"):
        trd.window_shift_apply_bt(xs, shifted, (1, 2), bl)
