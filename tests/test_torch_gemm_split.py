"""The arithmetic of K12 (matmul_nt on the tensor cores, csrc/gemm.cu) on
the CPU.

The kernel splits each f32 operand into three bf16 pieces, x = x0 + x1 + x2
exactly (split_bf16x3), and sums the eight largest products of the pieces
a term: a0·b0 into one f32 accumulator (acc_hi), the seven cross terms
into another (acc_lo), one wgmma of 16 products at a time, and writes
__fadd_rn(acc_hi, acc_lo). The tensor cores' f32 accumulation rounds toward
zero (measured on the card: chip_smoke.py gemm_diag). `_emulate` repeats
that order with numpy: per wgmma, the accumulator plus the 16 products
rounded toward zero to f32, either exactly summed first or (guard_bits)
each addend first cut toward zero to the grid of the largest one, as the
hardware aligns them. Every element must stay within matmul_nt's bound
K·2^-24·(|A||B|ᵀ) + 2^-24·|C| of the exact product, on four input kinds,
and agree with the Pallas kernel in interpret mode; the kind `huge` puts
operands between bf16's largest finite value and f32's into every row. A
two-piece TF32 split cannot: one seeded case at K = 1 shows it.
"""

import numpy as np
import pytest
import torch

from lilac_tpu.kernels import pallas_gemm as jgemm
from lilac_tpu_torch.kernels import gemm as tgemm

torch.set_num_threads(1)

KINDS = ("normal", "positive", "wide", "dense_bits", "huge")
F32_MAX = float(np.finfo(np.float32).max)
SHAPES = ((1, 1, 1), (17, 33, 5), (150, 90, 70), (300, 260, 600))
STEP = 16  # K of one wgmma (m64n128k16)
# the kernel's order within a step: acc_hi then the 7 cross terms into acc_lo
CROSS = ((0, 1), (1, 0), (1, 1), (0, 2), (2, 0), (1, 2), (2, 1))


def _operand(rng, rows, k, kind):
    """One operand of the input kinds of chip_smoke.py's gemm phase."""
    if kind in ("normal", "huge"):
        return rng.standard_normal((rows, k)).astype(np.float32)
    if kind == "positive":
        return rng.random((rows, k)).astype(np.float32)
    if kind == "wide":  # rows and columns scaled by 2^e, e in [-40, 40]
        e = rng.integers(-20, 21, size=(rows, 1)) + rng.integers(-20, 21, size=(1, k))
        return (rng.standard_normal((rows, k)) * np.exp2(e)).astype(np.float32)
    frac = rng.integers(0, 1 << 23, size=(rows, k)).astype(np.float64)  # dense_bits
    sign = rng.choice([-1.0, 1.0], size=(rows, k))
    return (sign * (1.0 + frac * 2.0 ** -23)
            * np.exp2(rng.integers(-4, 5, size=(rows, k)))).astype(np.float32)


def _operands(rng, m, n, k, kind):
    """A [m, k] and Bt [n, k] of one kind. `huge`: standard normal, but
    column 0 of A and column 1 of Bt lie between bf16's largest finite
    value and f32's (either sign), the other operand's entries there in
    (-1/4, 1/4), so every product and sum stays finite."""
    A, BT = _operand(rng, m, k, kind), _operand(rng, n, k, kind)
    if kind == "huge":
        for big, small, j in ((A, BT, 0), (BT, A, 1)):
            if j < k:
                big[:, j] = (rng.uniform(float(tgemm.BF16_MAX), F32_MAX, big.shape[0])
                             * rng.choice([-1.0, 1.0], big.shape[0]))
                small[:, j] = rng.uniform(-0.25, 0.25, small.shape[0])
    return A, BT


def _bound(A, BT):
    """(f64 product, K·2^-24·(|A|·|B|ᵀ) + 2^-24·|C|)."""
    a64, b64 = A.astype(np.float64), BT.astype(np.float64)
    c = a64 @ b64.T
    u = 2.0 ** -24
    return c, A.shape[1] * u * (np.abs(a64) @ np.abs(b64).T) + u * np.abs(c)


def _rz32(x):
    """f64 -> f32 rounded toward zero."""
    r = x.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(x)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def _pieces(x):
    return tgemm.split_bf16x3_plain(torch.as_tensor(x))[0][:, :, :x.shape[1]].double().numpy()


def _step(acc, prods, guard_bits):
    """acc [M, N] f32 + prods [M, N, 16] (exact f64) -> f32, toward zero."""
    terms = np.concatenate([acc.astype(np.float64)[..., None], prods], axis=-1)
    if guard_bits is not None:  # each addend cut to the largest one's grid
        big = np.abs(terms).max(axis=-1, keepdims=True)
        _, e = np.frexp(np.where(big > 0, big, 1.0))
        scale = np.ldexp(1.0, (24 + guard_bits - e).astype(np.int64))
        terms = np.trunc(terms * scale) / scale
    return _rz32(terms.sum(axis=-1))


def _emulate(A, BT, guard_bits=None):
    """K12's sums on the CPU: the pieces, acc_hi / acc_lo by wgmma step in
    the kernel's order, then __fadd_rn(acc_hi, acc_lo)."""
    pa, pb = _pieces(A), _pieces(BT)
    M, N, K = A.shape[0], BT.shape[0], A.shape[1]
    hi = np.zeros((M, N), dtype=np.float32)
    lo = np.zeros((M, N), dtype=np.float32)
    for k0 in range(0, K, STEP):
        ks = slice(k0, min(k0 + STEP, K))

        def prods(i, j):
            return pa[i][:, None, ks] * pb[j][None, :, ks]

        hi = _step(hi, prods(0, 0), guard_bits)
        for i, j in CROSS:
            lo = _step(lo, prods(i, j), guard_bits)
    return hi + lo  # float32 + float32: round to nearest, as __fadd_rn


# ---- the split ---------------------------------------------------------------


def _bf16_rne(x):
    """f32 -> bf16 (as f32) by the bits: round to nearest, ties to even."""
    b = np.asarray(x, dtype=np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


def _split_inputs(case, rng):
    if case == "normal_range":  # every exponent from 2^-110 up, both signs
        e = rng.integers(-110, 128, size=20000)
        x = rng.uniform(1.0, 2.0, size=20000) * np.exp2(e) * rng.choice([-1.0, 1.0], 20000)
        return np.clip(x, -F32_MAX, F32_MAX).astype(np.float32)
    if case == "zeros":
        return np.array([0.0, -0.0, 1.0, -1.0, F32_MAX, -F32_MAX], dtype=np.float32)
    if case == "top":  # every f32 above bf16's largest finite value, both signs
        bits = np.arange(0x7F7F0001, 0x7F800000, dtype=np.uint32)
        bits[::2] |= 0x80000000
        return bits.view(np.float32)
    # ties at the bf16 rounding points and their neighbours, exponents from
    # 2^-110 up (below it the last piece may fall among bf16's subnormals)
    hi = rng.integers(0x0900, 0x7F80, size=3000).astype(np.uint32) << 16
    low = np.array([0x8000, 0x7FFF, 0x8001, 0x0000, 0xFFFF], dtype=np.uint32)
    bits = (hi[:, None] | low[None, :]).ravel()
    bits[::2] |= 0x80000000
    return bits.view(np.float32)


@pytest.mark.parametrize("case", ["normal_range", "zeros", "ties", "top"])
def test_split_is_exact_and_rounds_to_nearest(case):
    """The three pieces sum back to x exactly; x0 and x1 are the bf16
    nearest (ties to even) of x and of x - x0, computed by the bits, but
    above bf16's largest finite value x0 is x cut toward zero (its top 16
    bits), never infinity."""
    rng = np.random.default_rng(5)
    x = _split_inputs(case, rng)
    (p,) = tgemm.split_bf16x3_plain(torch.as_tensor(x[None, :]))
    p = p.float().numpy()[:, 0, :x.size]
    assert np.isfinite(p).all()
    assert np.array_equal(p.astype(np.float64).sum(axis=0), x.astype(np.float64))
    top = np.abs(x) > tgemm.BF16_MAX
    assert top.all() or case != "top"
    want0 = np.where(top, (x.view(np.uint32) & 0xFFFF0000).view(np.float32), _bf16_rne(x))
    np.testing.assert_array_equal(p[0].view(np.uint32), want0.view(np.uint32))
    r1 = x - p[0]
    np.testing.assert_array_equal(p[1].view(np.uint32), _bf16_rne(r1).view(np.uint32))
    np.testing.assert_array_equal(p[2], r1 - p[1])  # the rest is a bf16 already
    # each piece is at most 2^-8 of the one above it (x0 rounded to nearest),
    # 2^-7 where x0 was cut toward zero
    near = (np.abs(p[0]) > 0) & ~top
    assert np.all(np.abs(p[1][near]) <= np.abs(p[0][near]) * 2.0 ** -8)
    assert np.all(np.abs(p[2][near]) <= np.abs(p[0][near]) * 2.0 ** -16)
    assert np.all(np.abs(p[1][top]) <= np.abs(p[0][top]) * 2.0 ** -7)
    assert np.all(np.abs(p[2][top]) <= np.abs(p[0][top]) * 2.0 ** -15)


def test_split_pads_and_takes_two_operands():
    rng = np.random.default_rng(6)
    a = torch.as_tensor(rng.standard_normal((5, 70)).astype(np.float32))
    b = torch.as_tensor(rng.standard_normal((3, 70)).astype(np.float32))
    pa, pb = tgemm.split_bf16x3(a, b)  # CPU tensors take the plain version
    assert pa.shape == (3, 5, 96) and pb.shape == (3, 3, 96)
    assert pa.dtype == torch.bfloat16 and not pa[:, :, 70:].any()
    (pa2,) = tgemm.split_bf16x3_plain(a.T.contiguous().T)  # strides do not matter
    assert torch.equal(pa2, pa)
    assert tgemm.split_bf16x3.launches == 0
    with pytest.raises(ValueError, match="one or two"):
        tgemm.split_bf16x3(a, b, a)
    with pytest.raises(ValueError, match="one K"):
        tgemm.split_bf16x3(a, b[:, :69])
    with pytest.raises(ValueError, match="float32"):
        tgemm.split_bf16x3(a.double())


@pytest.mark.parametrize("K,kp", [(0, 32), (1, 32), (32, 32), (33, 64), (70, 96),
                                  (4096, 4096)])
def test_padded_k(K, kp):
    assert tgemm.padded_k(K) == kp


# ---- the kernel's sums ---------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("m,n,k", SHAPES)
def test_emulated_sums_within_bound(m, n, k, kind):
    """Per wgmma step, exact sums rounded toward zero, as gemm_diag measures."""
    rng = np.random.default_rng(m + n + k + len(kind))
    A, BT = _operands(rng, m, n, k, kind)
    c64, bound = _bound(A, BT)
    C = _emulate(A, BT)
    assert C.dtype == np.float32 and np.isfinite(C).all()
    assert np.all(np.abs(C - c64) <= bound)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("m,n,k", SHAPES[:3])
def test_emulated_aligned_sums_within_bound(m, n, k, kind):
    """The pessimistic model: every addend of a step first cut toward zero
    to 2 bits below the largest one's ulp (gemm_diag: the hardware keeps at
    least 2 and fewer than 7)."""
    rng = np.random.default_rng(m + n + k + len(kind))
    A, BT = _operands(rng, m, n, k, kind)
    c64, bound = _bound(A, BT)
    assert np.all(np.abs(_emulate(A, BT, guard_bits=2) - c64) <= bound)


@pytest.mark.parametrize("a,b", [(3.4e38, 0.5), (-F32_MAX, 0.25), (3.3962e38, -1.0)])
def test_top_of_f32_range_product_is_finite(a, b):
    """A finite product of an operand above bf16's largest finite value
    stays finite and within the bound (x0 cut toward zero, not infinity)."""
    A = np.array([[a, 1.5]], dtype=np.float32)
    BT = np.array([[b, -2.0]], dtype=np.float32)
    c64, bound = _bound(A, BT)
    C = _emulate(A, BT)
    assert np.isfinite(C).all() and np.all(np.abs(C - c64) <= bound)
    assert torch.equal(tgemm.gemm_bf16x3(*tgemm.split_bf16x3(
        torch.as_tensor(A), torch.as_tensor(BT))), tgemm.matmul_nt_plain(
        torch.as_tensor(A), torch.as_tensor(BT)))


@pytest.mark.parametrize("m,n,k", [(150, 90, 70), (300, 260, 600)])
def test_emulation_matches_pallas_interpret(m, n, k):
    """The emulated kernel and the Pallas kernel (interpret mode) are both
    within the bound of the exact product, so within twice it of each
    other, and both pass parboil's compare."""
    from lilac_tpu_torch.workloads import parboil_spmv as tpv

    rng = np.random.default_rng(m)
    A = rng.standard_normal((m, k)).astype(np.float32)
    BT = rng.standard_normal((n, k)).astype(np.float32)
    c64, bound = _bound(A, BT)
    C = _emulate(A, BT)
    jc = np.asarray(jgemm.matmul_nt(A, BT))  # interpret mode on the CPU
    assert np.all(np.abs(jc - c64) <= bound)
    assert np.all(np.abs(C - c64) <= bound)
    assert np.all(np.abs(C.astype(np.float64) - jc) <= 2 * bound)
    assert tpv.compare(jc.ravel(), C.ravel())


def _tf32_rne(x):
    """f32 -> TF32 (10 stored bits) as f32, round to nearest even."""
    b = np.asarray(x, dtype=np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0xFFF + ((b >> 13) & 1)) & 0xFFFFE000
    return b.astype(np.uint32).view(np.float32)


def test_two_piece_tf32_breaks_the_bound_at_k1():
    """3xTF32 (a = a_hi + a_lo in TF32, a_lo·b_lo dropped, f32 sums) misses
    the bound at K = 1 on a share of standard-normal pairs; the three-piece
    bf16 sums hold it on the same pairs."""
    rng = np.random.default_rng(2024)
    a = rng.standard_normal((20000, 1)).astype(np.float32)
    b = rng.standard_normal((1, 1)).astype(np.float32)
    c64, bound = _bound(a, b)
    ah, bh = _tf32_rne(a), _tf32_rne(b)
    al, bl = _tf32_rne(a - ah), _tf32_rne(b - bh)
    c3 = (ah * bh + ah * bl) + al * bh  # float32 products (exact) and sums
    broken = np.abs(c3.astype(np.float64) - c64) > bound
    assert broken.mean() > 0.01
    assert np.all(np.abs(_emulate(a, b) - c64) <= bound)


# ---- the wrappers ----------------------------------------------------------------


def test_matmul_nt_wrapper_on_the_cpu():
    """Shapes, dtypes and K = 0; CPU tensors take the plain version, the
    pieces' GEMM the f64 product of what they sum to."""
    z = tgemm.matmul_nt(torch.zeros(5, 0), torch.zeros(7, 0))
    assert z.shape == (5, 7) and z.dtype == torch.float32 and not z.any()
    rng = np.random.default_rng(9)
    a = torch.as_tensor(rng.standard_normal((6, 40)).astype(np.float32))
    b = torch.as_tensor(rng.standard_normal((4, 40)).astype(np.float32))
    want = tgemm.matmul_nt_plain(a, b)
    assert torch.equal(tgemm.matmul_nt(a, b), want)
    assert torch.equal(tgemm.gemm_bf16x3(*tgemm.split_bf16x3(a, b)), want)
    assert tgemm.matmul_nt.launches == 0 and tgemm.gemm_bf16x3.launches == 0
    with pytest.raises(ValueError, match="A \\[M, K\\] and Bt \\[N, K\\]"):
        tgemm.matmul_nt(a, b[:, :39])
    with pytest.raises(ValueError, match="float32"):
        tgemm.matmul_nt(a.double(), b)
    pa, pb = tgemm.split_bf16x3(a, b)
    with pytest.raises(ValueError, match="bf16 pieces"):
        tgemm.gemm_bf16x3(pa.float(), pb)
    with pytest.raises(ValueError, match="bf16 pieces"):
        tgemm.gemm_bf16x3(pa[:, :, :32], pb)
