"""The window pass (K5 window_shift_apply_b, K5u window_shift_apply) as the
CUDA kernel of csrc/hier.cu partitions it, on the CPU.

The kernel cuts each window block of bl output slots into bl / C thread
blocks of C slots (the span, window_span). A thread block stages only the
mask bytes its walks can read, [w0, bl + c0 + C) of the (left, self)
window with w0 = (bl + c0 - sum(d)) rounded down to 16, and a thread walks
4 consecutive slots back through the stages to the slot its value came
from. `_emulate` below does the same with numpy, every mask byte a thread
block does not stage poisoned and every read checked inside the staged
range; it must equal window_shift_apply_plain bit for bit (signed zeros
and NaN payloads included) at every span, and the plain version must equal
the Pallas kernel in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lilac_tpu.kernels import routed as jrd
from lilac_tpu_torch.kernels import routed as trd

torch.set_num_threads(1)

POISON = 0xA5  # a mask byte with stage bits 0, 2, 5, 7 set


def _planes(rng, dtype, nplanes, shape):
    """Random planes with signed zeros and NaNs of many payloads."""
    n = int(np.prod(shape))
    out = []
    for _ in range(nplanes):
        v = rng.standard_normal(n).astype(dtype)
        v[rng.random(n) < 0.03] = -0.0
        ints = v.view(np.uint32 if dtype == np.float32 else np.uint64)
        nan = rng.random(n) < 0.02
        base = 0x7FC00000 if dtype == np.float32 else 0x7FF8000000000000
        ints[nan] = base + rng.integers(1, 1 << 20, size=int(nan.sum())).astype(ints.dtype)
        out.append(v.reshape(shape))
    return out


def _phys(b, layout):
    return sum(((b >> src) & 1) << k for k, src in enumerate(layout))


def _emulate(xs, masks, dists, bl, span, layout=None):
    """The kernel's thread blocks in numpy. xs: planes [mrows, 128] shared
    or [N, mrows, 128]; masks [N, nblocks, 2R, 128] int8. Returns [N, mrows,
    128] planes (words as unsigned ints)."""
    N, nblocks = masks.shape[:2]
    m = nblocks * bl
    layout = tuple(range(nblocks.bit_length() - 1)) if layout is None else layout
    sumd = sum(dists)
    smem = trd.window_smem_bytes(span, dists)
    words = [x.view(np.uint32 if x.dtype == np.float32 else np.uint64) for x in xs]
    flat = [w.reshape(-1, m) for w in words]  # [1 or N, m]
    outs = [np.zeros((N, m), dtype=w.dtype) for w in words]
    mk = masks.reshape(N, nblocks, 2 * bl).view(np.uint8)
    for n in range(N):
        src_net = [f[n if f.shape[0] > 1 else 0] for f in flat]
        for b in range(nblocks):
            left = _phys((b + nblocks - 1) % nblocks, layout) * bl
            self_ = _phys(b, layout) * bl
            for c0 in range(0, bl, span):
                w0 = (bl + c0 - sumd) & ~15
                staged = bl + c0 + span - w0
                assert 0 <= w0 and staged % 16 == 0 and staged <= smem
                sh = np.full(smem, POISON, dtype=np.uint8)
                sh[:staged] = mk[n, b, w0:w0 + staged]
                # span / 4 threads of 4 consecutive slots: one array of slots
                w = bl + c0 + np.arange(span)
                for s in range(len(dists) - 1, -1, -1):
                    pos = w - w0
                    assert pos.min() >= 0 and pos.max() < staged
                    w = w - ((sh[pos] >> s) & 1).astype(np.int64) * dists[s]
                src = np.where(w >= bl, self_ + (w - bl), left + w)
                for o, f in zip(outs, src_net):
                    o[n, b * bl + c0:b * bl + c0 + span] = f[src]
    return [o.reshape(N, m // 128, 128) for o in outs]


def _shift_sets(bl):
    """One shift, NPB's four, the general matrix's eight (sum 255), one
    shift of bl - 1 and eight that sum to bl - 1."""
    top = [bl >> j for j in range(1, 8)]
    return [(1,), (1, 2, 4, 8), tuple(1 << j for j in range(8)), (bl - 1,),
            tuple(top + [bl - 1 - sum(top)])]


_FORMATS = {"f32": (np.float32, 1), "df64_pair": (np.float32, 2), "f64": (np.float64, 1)}


@pytest.mark.parametrize("fmt", list(_FORMATS))
@pytest.mark.parametrize("nets", [1, 3])
@pytest.mark.parametrize("bl", [256, 512])
def test_partition_emulation_matches_plain(bl, nets, fmt):
    """Every span the kernel takes at this bl, every shift set (sum(d) up to
    bl - 1), random masks (so block 0 reaches into block nblocks - 1),
    identity and scrambled layouts, shared and per-net input."""
    dtype, nplanes = _FORMATS[fmt]
    rng = np.random.default_rng(bl + 7 * nets + len(fmt))
    nblocks = 8
    m = nblocks * bl
    spans = [s for s in (128, 256, 512) if s <= bl]
    for j, (span, dists) in enumerate((s, d) for s in spans for d in _shift_sets(bl)):
        layout = (2, 0, 1) if j % 2 else None
        per_net = nets > 1 and j % 3 != 0
        masks = rng.integers(0, 256, size=(nets, nblocks, 2 * bl // 128, 128),
                             dtype=np.uint8).view(np.int8)
        xs = _planes(rng, dtype, nplanes, ((nets,) if per_net else ()) + (m // 128, 128))
        got = _emulate(xs, masks, dists, bl, span, layout)
        want = trd.window_shift_apply_plain([torch.as_tensor(x) for x in xs],
                                            torch.as_tensor(masks), dists, bl,
                                            layout=layout)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w.numpy().view(g.dtype))


@pytest.mark.parametrize("span", [None, 128, 256])
def test_wrappers_take_a_span(span):
    """The wrappers check a forced span on the CPU and give the plain
    version's result; one net is N = 1."""
    rng = np.random.default_rng(3)
    bl, nblocks = 256, 4
    masks = rng.integers(0, 256, size=(nblocks, 2 * bl // 128, 128),
                         dtype=np.uint8).view(np.int8)
    xs = [torch.as_tensor(x) for x in _planes(rng, np.float32, 2, (nblocks * bl // 128, 128))]
    tm = torch.as_tensor(masks)
    want = trd.window_shift_apply_plain(xs, tm, (1, 2, 4), bl)
    for got in (trd.window_shift_apply(xs, tm, (1, 2, 4), bl, span=span),
                trd.window_shift_apply_b(xs, tm[None], (1, 2, 4), bl, span=span)):
        for g, w in zip(got, want):
            assert torch.equal(g.reshape(w.shape).view(torch.int32), w.view(torch.int32))
    assert trd.window_shift_apply.launches == 0 and trd.window_shift_apply_b.launches == 0


@pytest.mark.parametrize("span", [64, 96, 512, 8192])
def test_bad_span_raises(span):
    bl = 256
    with pytest.raises(ValueError, match="window span"):
        trd.window_span(bl, span)


def test_span_and_shared_memory():
    """The default span, the launch shape it gives and the staged bytes."""
    assert trd.window_span(256) == trd.WINDOW_SPAN == 128
    assert trd.window_span(1 << 13) == 128 and trd.window_span(1 << 13, 1024) == 1024
    cfg = trd.window_launch_config(1 << 13, tuple(1 << j for j in range(8)),
                                   nblocks=64)
    # one net of the general matrix (m = 2^19): 4096 thread blocks of 32 threads
    assert cfg == {"grid": [4096, 1], "threads": 32, "span": 128,
                   "smem_bytes": (128 + 255 + 30) & ~15}
    for span in (128, 1024, 4096):
        for dists in _shift_sets(1 << 13):
            smem = trd.window_smem_bytes(span, dists)
            assert smem % 16 == 0 and smem >= span + sum(dists) + 15


@pytest.mark.parametrize("nplanes,esize", [(1, 4), (2, 4), (1, 8)])
def test_pass_smem_bytes_describes_the_window_pass(nplanes, esize):
    """A window pass is sized by its adjoint (bl + sum(d) slots with their
    mask bytes), which is always more than the forward's staged mask bytes
    at any span, so the feasibility of a plan is unchanged: the default bl
    of an H100 still fits the widest shift sets."""
    for bl in (256, 1 << 13):
        for dists in _shift_sets(bl):
            need = trd.pass_smem_bytes(("window", dists), bl, nplanes, esize)
            assert need == (bl + sum(dists) + 3) // 4 * 4 * (nplanes * esize + 1)
            assert need > max(trd.window_smem_bytes(s, dists)
                              for s in (128, 256, 512, 1024, 2048, 4096) if s <= bl)
    bl = trd.default_hier_bl()
    assert bl == 1 << 13
    trd.check_smem_feasible([("window", (bl - 1,))], bl, 2, 4)


@pytest.mark.parametrize("batched", [True, False], ids=["batched", "one_net"])
@pytest.mark.parametrize("dists", [(1, 2, 4, 8), (128, 64, 32, 16, 8, 4, 2, 1)],
                         ids=["npb", "reach"])
def test_emulation_matches_pallas_interpret(dists, batched):
    """The thread-block emulation at span 128 against the Pallas kernel in
    interpret mode, an f32 (hi, lo) pair through a scrambled layout. The
    Pallas kernel shifts by 128 * (d // 128) where d >= 128, which is exact
    for the power-of-two distances compile_hier builds (here up to a reach
    of bl - 1); the port's kernel and plain version take any d."""
    rng = np.random.default_rng(17)
    bl, nblocks, N = 256, 8, 2
    m = nblocks * bl
    layout = (1, 2, 0)
    masks = rng.integers(0, 256, size=(N, nblocks, 2 * bl // 128, 128),
                         dtype=np.uint8).view(np.int8)
    xs = [rng.standard_normal(((N,) if batched else ()) + (m // 128, 128)).astype(np.float32)
          for _ in range(2)]
    if batched:
        want = jrd.window_shift_apply_b([jnp.asarray(x) for x in xs], jnp.asarray(masks),
                                        dists, bl, layout=layout, interpret=True)
    else:
        want = [np.asarray(w)[None] for w in jrd.window_shift_apply(
            [jnp.asarray(x) for x in xs], jnp.asarray(masks[0]), dists, bl,
            layout=layout, interpret=True)]
    got = _emulate(xs, masks if batched else masks[:1], dists, bl, 128, layout)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w).view(np.uint32))
