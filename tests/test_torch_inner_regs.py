"""The register schedule of the inner pass (K3 routed_apply_sliced_b, K3u
routed_apply_sliced, K7 routed_apply_sliced_bt) and the locality the CUDA
kernel relies on, on the CPU.

inner_runs cuts a pass's xor stages into runs; csrc/inner_pass.cuh holds a
block's slots in its threads' registers, runs a stage on a register bit as
a select and a stage on a lane bit as a warp shuffle, and passes the block
through swizzled shared memory between runs. `_emulate` below does the same
with numpy: per thread its 2^rb registers, per warp the shuffles, the mask
words the kernel builds, shared memory only between runs and poisoned (a
NaN pattern) once a run has read it, so a slot no thread writes back shows.
It must equal the plain versions bit for bit (signed zeros and NaN payloads
included) on random stage orders, masks, layouts, net counts and word
widths, forwards and reversed, and the Pallas kernels in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lilac_tpu.kernels import routed as jrd
from lilac_tpu_torch.kernels import routed as trd

torch.set_num_threads(1)

POISON = np.int32(0x7FC0DEAD)  # a NaN no input holds


def _benes(L):
    return tuple([1 << k for k in range(L - 1, -1, -1)] + [1 << k for k in range(1, L)])


def _order(kind, L, rng):
    """Stage distances of a pass: the Benes inner pass, one bit (one run),
    every bit in turn (many runs where the block has warp bits), or random."""
    if kind == "benes":
        return _benes(L)
    if kind == "one_bit":
        return (1 << (L - 1),) * 9
    if kind == "zigzag":
        return tuple(1 << (3 * j % L) for j in range(min(64, 4 * L)))
    return tuple(int(1 << b) for b in rng.integers(0, L, size=int(rng.integers(1, 65))))


# ---- (a) the schedule ------------------------------------------------------


def _check_runs(dists, bl, rb):
    L = bl.bit_length() - 1
    runs = trd.inner_runs(tuple(dists), bl, rb)
    codes = trd.inner_stage_codes(tuple(dists), runs, rb)
    assert len(codes) == len(dists)
    nxt = 0
    for a, b, perm in runs:
        assert a == nxt and a < b <= a + trd.INNER_MAX_RUN and a // 32 == (b - 1) // 32
        assert sorted(perm) == list(range(L))
        lanes = perm[rb:rb + trd.INNER_LANE_BITS]
        assert len({j % 5 for j in lanes}) == 5  # 32 banks for a warp
        local = perm[:rb + trd.INNER_LANE_BITS]
        for s in range(a, b):
            bit = dists[s].bit_length() - 1
            assert bit in local
            c = codes[s]
            assert perm[c if c < 8 else rb + c - 8] == bit
        # as long as it can be: the next stage has no assignment with this run
        if b < len(dists) and b % 32 and b - a < trd.INNER_MAX_RUN:
            bits = [d.bit_length() - 1 for d in dists[a:b + 1]]
            assert trd._run_layout(bits, L, rb) is None
        nxt = b
    assert nxt == len(dists)
    return runs


@pytest.mark.parametrize("log2bl,rb", [(7, 2), (8, 3), (9, 4), (11, 2), (11, 3), (11, 4),
                                       (13, 3), (13, 4), (14, 4)])
def test_inner_runs_cover_every_stage_locally(log2bl, rb):
    rng = np.random.default_rng(log2bl * 10 + rb)
    bl = 1 << log2bl
    for kind in ("benes", "one_bit", "zigzag", "random", "random", "random"):
        dists = _order(kind, log2bl, rng)
        runs = _check_runs(dists, bl, rb)
        if kind == "one_bit":
            assert len(runs) == 1
        _check_runs(tuple(reversed(dists)), bl, rb)


def test_benes_inner_pass_is_three_runs():
    """The 25-stage inner pass of a Benes network at bl = 2^13: 3 runs (2
    transposes) at 8 and at 16 slots a thread, and 10 of its stages are
    shuffles at 16."""
    dists = _benes(13)
    for rb in (3, 4):
        assert len(trd.inner_runs(dists, 1 << 13, rb)) == 3
    codes = trd.inner_stage_codes(dists, trd.inner_runs(dists, 1 << 13, 4), 4)
    assert sum(c >= 8 for c in codes) == 10
    assert trd.inner_reg_bits(1 << 13) == 4 and trd.inner_reg_bits(256) == 3
    assert trd.inner_reg_bits(128) == 2
    # a run holds at most 16 stages and never crosses a 32-stage mask word
    assert [r[:2] for r in trd.inner_runs((1,) * 64, 1 << 13)] == [
        (0, 16), (16, 32), (32, 48), (48, 64)]
    assert [r[:2] for r in trd.inner_runs((1,) * 20 + (2,) * 20, 1 << 13)] == [
        (0, 16), (16, 32), (32, 40)]


def test_inner_sched_struct_and_shared_memory():
    dists = _benes(13)
    sc = trd._inner_sched(dists, 1 << 13, 4)
    runs = trd.inner_runs(dists, 1 << 13, 4)
    assert sc.nruns == 3 and sc.rb == 4
    assert [(r.a, r.b, tuple(r.perm)[:13]) for r in sc.run[:3]] == list(runs)
    assert tuple(sc.code[:25]) == trd.inner_stage_codes(dists, runs, 4)
    # shared memory: the block's 32-bit words and a mask word a slot per 32 stages
    meta = ("inner", ("xor",) * 25, dists)
    assert trd.pass_smem_bytes(meta, 1 << 13, 2, 4) == 3 * 4 * (1 << 13)
    assert trd.pass_smem_bytes(meta, 1 << 13, 1, 8) == 3 * 4 * (1 << 13)
    assert trd.pass_smem_bytes(("inner", ("xor",) * 40, (1,) * 40), 1 << 13, 2, 8) \
        == 6 * 4 * (1 << 13)
    with pytest.raises(ValueError, match="inner pass"):
        trd.check_smem_feasible((meta,), 1 << 15, 1, 4, limit=1 << 30)
    for bad in ((3,), (256,)):
        with pytest.raises(ValueError, match="distance"):
            trd.inner_runs(bad, 256)


# ---- (b) the kernel, emulated ------------------------------------------------


def _swz(i):
    h = i >> 5
    return i ^ ((h ^ (h >> 5) ^ (h >> 10)) & 31)


def _deposit(v, bits):
    out = np.zeros_like(v)
    for t, b in enumerate(bits):
        out |= ((v >> t) & 1) << b
    return out


def _emulate(x_planes, masks, dists, layout, reverse, rb=None):
    """The inner pass as csrc/inner_pass.cuh runs it. x_planes [mrows, 128]
    (shared) or [N, mrows, 128]; masks [N, nblocks, P, R, 128] (or without
    N: one net)."""
    net_axis = masks.dim() == 5
    mk = (masks if net_axis else masks.unsqueeze(0)).numpy().view(np.uint8)
    N, nb, P, R, _ = mk.shape
    bl = R * 128
    L = bl.bit_length() - 1
    rb = trd.inner_reg_bits(bl) if rb is None else rb
    runs = trd.inner_runs(tuple(dists), bl, rb)
    codes = trd.inner_stage_codes(tuple(dists), runs, rb)
    phys = np.asarray(trd._phys_index(nb, layout, "cpu"))
    dtype = x_planes[0].dtype
    # 32-bit words: a 64-bit word is its low and high halves
    words = []
    for x in x_planes:
        a = x.numpy().reshape(-1, nb, bl)[:, phys]
        if a.dtype.itemsize == 4:
            words.append(a.view(np.int32))
        else:
            h = a.view(np.int32).reshape(a.shape + (2,))
            words += [h[..., 0], h[..., 1]]
    swz = _swz(np.arange(bl))
    sm = []
    for w in words:
        s = np.empty((N, nb, bl), np.int32)
        s[..., swz] = np.broadcast_to(w, (N, nb, bl))
        sm.append(s)
    planes = mk.reshape(N, nb, P, bl).astype(np.uint32)
    smask = []
    for g in range((P + 3) // 4):
        word = np.zeros((N, nb, bl), np.uint32)
        for j in range(4):
            if 4 * g + j < P:
                word |= planes[:, :, 4 * g + j] << np.uint32(8 * j)
        s = np.empty_like(word)
        s[..., swz] = word
        smask.append(s)
    T, NR = bl >> rb, 1 << rb
    tid = np.arange(T)[:, None]
    reg = np.arange(NR)[None, :]
    for a, b, perm in (reversed(runs) if reverse else runs):
        slot = _deposit(reg | (tid << rb), perm)  # [T, NR]
        addr = swz[slot]
        for k in range(NR):  # every warp access of the run reaches 32 banks
            banks = addr[:, k].reshape(-1, 32) % 32
            assert all(len(set(row)) == 32 for row in banks)
        regs = [s[..., addr] for s in sm]  # [N, nb, T, NR] each
        for s in sm:
            s[...] = POISON
        # the run's switches of each slot: 16 bits of its mask word
        m = (smask[a >> 5][..., addr] >> np.uint32(a & 31)) & np.uint32(0xFFFF)
        for st in (range(b - 1, a - 1, -1) if reverse else range(a, b)):
            take = ((m >> np.uint32(st - a)) & 1).astype(bool)
            c = codes[st]
            if c < 8:
                regs = [np.where(take, r[..., reg[0] ^ (1 << c)], r) for r in regs]
            else:  # the partner lane's same register: a shuffle within the warp
                partner = tid[:, 0] ^ (1 << (c - 8))
                assert (partner >> 5 == tid[:, 0] >> 5).all()
                regs = [np.where(take, r[..., partner, :], r) for r in regs]
        for s, r in zip(sm, regs):
            s[..., addr] = r
    outs = [s[..., swz] for s in sm]
    res = []
    it = iter(outs)
    for _ in x_planes:
        if dtype == torch.float32:
            v = next(it).view(np.float32)
        else:
            v = np.stack([next(it), next(it)], axis=-1).view(np.float64)[..., 0]
        res.append(torch.as_tensor(np.ascontiguousarray(v)).reshape(N, nb * R, 128))
    return tuple(res) if net_axis else tuple(r[0] for r in res)


def _bits(x):
    return x.contiguous().view(torch.int32 if x.element_size() == 4 else torch.int64)


def _planes(rng, fmt, shape):
    """f32 / f64 one plane, f32 two planes or a df64 pair, with signed zeros
    and NaNs of several payloads among the values."""
    dtype = np.float64 if fmt == "f64" else np.float32
    n = int(np.prod(shape))
    out = []
    for _ in range(2 if fmt in ("f32x2", "df") else 1):
        v = rng.standard_normal(n).astype(dtype)
        v[rng.random(n) < 0.02] = -0.0
        ints = v.view(np.int32 if dtype == np.float32 else np.int64)
        nan = rng.random(n) < 0.01
        base = 0x7FC00000 if dtype == np.float32 else 0x7FF8000000000000
        ints[nan] = base + rng.integers(1, 1000, size=int(nan.sum()))
        out.append(torch.as_tensor(v.reshape(shape)))
    return out


# (log2 bl, nblocks, order, N, input, layout, fmt, rb)
_CASES = [
    (11, 4, "benes", 3, "shared", None, "df", None),
    (11, 4, "random", 2, "per_net", "scrambled", "f32", None),
    (11, 2, "zigzag", 1, "per_net", None, "f64", None),
    (11, 4, "random", 16, "shared", "scrambled", "f32x2", 3),
    (10, 8, "random", 2, "per_net", "scrambled", "df", 2),
    (10, 4, "one_bit", 1, "shared", None, "f32", None),
    (9, 16, "benes", 2, "per_net", "scrambled", "f64", None),
    (8, 32, "random", 3, "shared", "scrambled", "df", None),
    (8, 8, "zigzag", 16, "per_net", None, "f32", None),
    (7, 16, "random", 2, "per_net", "scrambled", "f64", None),
]


def _case(case, reverse, seed):
    log2bl, nb, order, N, inp, layout, fmt, rb = case
    rng = np.random.default_rng(seed)
    bl = 1 << log2bl
    dists = _order(order, log2bl, rng)
    S = len(dists)
    masks = torch.as_tensor(rng.integers(
        0, 256, size=(N, nb, (S + 7) // 8, bl // 128, 128), dtype=np.uint8).view(np.int8))
    lay = None
    if layout == "scrambled":
        lay = tuple(int(v) for v in rng.permutation(nb.bit_length() - 1))
    per_net = inp == "per_net" or reverse  # the adjoint takes per-net cotangents
    xs = _planes(rng, fmt, ((N,) if per_net else ()) + (nb * bl // 128, 128))
    return dists, masks, lay, xs, rb


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("case", _CASES, ids=[f"c{i}" for i in range(len(_CASES))])
def test_emulation_equals_plain(case, reverse):
    dists, masks, lay, xs, rb = _case(case, reverse, 7)
    kinds = ("xor",) * len(dists)
    got = _emulate(xs, masks, dists, lay, reverse, rb)
    if reverse:
        want = trd.routed_apply_sliced_bt_plain(xs, masks, kinds, dists, layout=lay)
    else:
        want = trd.routed_apply_sliced_plain(xs, masks, kinds, dists, layout=lay)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(_bits(g), _bits(w))
    if not reverse and case[3] == 1:  # one net: the un-batched K3u too
        one = tuple(x[0] if x.dim() == 3 else x for x in xs)
        got1 = _emulate(one, masks[0], dists, lay, False, rb)
        want1 = trd.routed_apply_sliced_plain(one, masks[0], kinds, dists, layout=lay)
        for g, w in zip(got1, want1):
            assert torch.equal(_bits(g), _bits(w))


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("case", [_CASES[1], _CASES[4], _CASES[7]],
                         ids=["bl2048", "bl1024", "bl256"])
def test_emulation_equals_pallas_interpret(case, reverse):
    """The same emulation against the JAX package's Pallas kernels in
    interpret mode (routed_apply_sliced_b / routed_apply_sliced_bt), with
    NaN-free values (the comparison is exact)."""
    dists, masks, lay, xs, rb = _case(case, reverse, 8)
    xs = [torch.where(torch.isnan(x), torch.zeros_like(x), x) for x in xs]
    kinds = ("xor",) * len(dists)
    fn = jrd.routed_apply_sliced_bt if reverse else jrd.routed_apply_sliced_b
    want = fn([jnp.asarray(x.numpy()) for x in xs], jnp.asarray(masks.numpy()), kinds,
              dists, layout=lay, interpret=True)
    got = _emulate(xs, masks, dists, lay, reverse, rb)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g).numpy(), np.asarray(w).view(
            np.int32 if g.element_size() == 4 else np.int64))
