"""The kernels of csrc/dfops.cu against DF64Alg's op chains on a CUDA card,
bit for bit (NaN where the chain gives NaN).

Marked `card`: it skips where there is no CUDA card or no nvcc. It imports
no JAX, so on a machine with a card it runs on its own, without the JAX
settings of tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_dfops_card.py
"""

import os
import shutil

import numpy as np
import pytest
import torch

from lilac_tpu_torch.kernels import _cuda, dfops
from lilac_tpu_torch.ops import dfloat as df
from lilac_tpu_torch.solvers.algebra import DF64Alg

SIZES = (1, 7, 4097, 150000, 1500000, 4096000)
# each kernel entry and the DF64Alg method whose chain it runs
METHOD = {"add": "add", "sub": "sub", "mul": "smul", "div": "sdiv", "sqrt": "ssqrt"}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")
    if not (shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc")
            or os.environ.get("CUDA_HOME")):
        pytest.skip("needs nvcc to build csrc/dfops.cu")


def _chain(entry, *args):
    """DF64Alg's method with the kernels refused: the eager op chain."""
    shape = dfops.result_shape
    dfops.result_shape = lambda *operands: None
    try:
        return getattr(DF64Alg("cuda"), METHOD[entry])(*args)
    finally:
        dfops.result_shape = shape


def _same(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype and g.is_cuda
        g, w = g.contiguous(), w.contiguous()
        same = (g.view(torch.int32) == w.view(torch.int32)) | (g.isnan() & w.isnan())
        assert bool(same.all()), int((~same).sum())


def _vectors(n, seed, edge):
    """Two df vectors on the card spread over 12 decades; with `edge`, hi
    words from +-0, subnormals, +-inf and values one ulp apart, lo words of
    either sign or -0, and the second's hi words cancelling the first's at
    every third term."""
    rng = np.random.default_rng(seed)
    if not edge:
        a = rng.standard_normal(n) * 10.0 ** rng.uniform(-6, 6, n)
        b = rng.standard_normal(n) * 10.0 ** rng.uniform(-6, 6, n)
        return df.from_f64(a, "cuda"), df.from_f64(b, "cuda")
    eps = 2.0 ** -23
    vals = np.array([1 + eps, 1 - eps / 2, 4097.0, 16777215.0, 0.1, -0.1, 1e-10,
                     1e10, 0.0, -0.0, 1e-40, -2e-39, np.inf, -np.inf, 3e38, 1.0 / 3.0],
                    dtype=np.float32)

    def plane():
        hi = vals[rng.integers(0, len(vals), n)]
        lo = hi * np.float32(2.0 ** -30) * rng.uniform(-1, 1, n).astype(np.float32)
        lo[~np.isfinite(lo)] = 0.0
        lo[rng.random(n) < 0.2] = np.float32(-0.0)
        return torch.as_tensor(hi, device="cuda"), torch.as_tensor(lo, device="cuda")

    (ah, al), (bh, bl) = plane(), plane()
    bh[1::3] = -ah[1::3]
    return df.DF(ah, al), df.DF(bh, bl)


@pytest.mark.card
@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("entry", list(METHOD))
@pytest.mark.parametrize("n", SIZES)
def test_vector_entry_is_the_chain_bit_for_bit(n, entry, edge):
    _card()
    u, v = _vectors(n, n + edge, edge)
    args = (u,) if entry == "sqrt" else (u, v)
    before = dfops.launches[entry]
    got = getattr(dfops, entry)(*args)
    assert dfops.launches[entry] - before == 1
    _same(got, _chain(entry, *args))


@pytest.mark.card
@pytest.mark.parametrize("entry", ["add", "sub", "mul", "div"])
@pytest.mark.parametrize("n", SIZES)
def test_scalar_with_vector_and_with_scalar(n, entry):
    _card()
    u, v = _vectors(n, 3 * n, False)
    s = df.DF(u.hi[n // 2].clone(), u.lo[n // 2].clone())
    t = df.DF(v.hi[0].clone(), v.lo[0].clone())
    for args in ((s, v), (v, s), (s, t)):
        got = getattr(dfops, entry)(*args)
        assert got.hi.shape == (() if args[1] is t else (n,))
        _same(got, _chain(entry, *args))


@pytest.mark.card
@pytest.mark.parametrize("edge", [False, True])
def test_scalar_calls_over_many_values(edge):
    """0-dim by 0-dim, one thread a call, over 40 pairs of each kind."""
    _card()
    u, v = _vectors(40, 17 + edge, edge)
    for i in range(40):
        a = df.DF(u.hi[i].clone(), u.lo[i].clone())
        b = df.DF(v.hi[i].clone(), v.lo[i].clone())
        for entry in METHOD:
            args = (a,) if entry == "sqrt" else (a, b)
            _same(getattr(dfops, entry)(*args), _chain(entry, *args))


@pytest.mark.card
@pytest.mark.parametrize("entry", list(METHOD))
def test_strided_planes(entry):
    _card()
    u, v = _vectors(4097, 5, False)
    wide = [torch.zeros(2 * 4097, device="cuda") for _ in range(2)]
    for w, t in zip(wide, u):
        w[::2] = t
    strided = df.DF(wide[0][::2], wide[1][::2])
    args = (strided,) if entry == "sqrt" else (strided, v)
    got = getattr(dfops, entry)(*args)
    _same(got, _chain(entry, *args))
    _same(got, getattr(dfops, entry)(*((u,) if entry == "sqrt" else (u, v))))


@pytest.mark.card
def test_zero_numerator_and_the_root_of_zero():
    """sdiv of +-0 over +-0 and over finite divisors gives that zero (the
    chain's bits); ssqrt of +-0 gives df.sqrt's bits."""
    _card()
    scalar = lambda x: df.full((), x, device="cuda")  # noqa: E731
    zeros = [scalar(0.0), df.neg(scalar(0.0))]
    for num in zeros:
        for den in zeros + [scalar(2.5), scalar(-3e-40), scalar(7e30)]:
            got = dfops.div(num, den)
            _same(got, _chain("div", num, den))
            _same(got, df.DF(num.hi, num.hi))
        _same(dfops.sqrt(num), df.sqrt(num))


@pytest.mark.card
def test_df64alg_takes_the_kernels_on_the_card():
    _card()
    alg = DF64Alg("cuda")
    u, v = _vectors(4097, 9, False)
    s = df.DF(u.hi[0].clone(), u.lo[0].clone())
    before = dict(dfops.launches)
    alg.add(u, v), alg.sub(u, v), alg.smul(s, v), alg.sdiv(s, s), alg.ssqrt(s)
    assert {k: dfops.launches[k] - before[k] for k in before} == {
        "add": 1, "sub": 1, "mul": 1, "div": 1, "sqrt": 1}
    # the launch goes to torch's current stream, on another stream too
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        assert _cuda.launch_on(0, lambda st: st) == torch.cuda.current_stream().cuda_stream
        got = alg.add(u, v)
    side.synchronize()
    _same(got, _chain("add", u, v))
    assert _cuda.launch_on(0, lambda st: st) == torch.cuda.current_stream().cuda_stream
    # f64 planes on the card: the chain, no launch
    w = df.DF(u.hi.double(), u.lo.double())
    got = alg.add(w, w)
    assert got.hi.dtype == torch.float64 and dfops.launches["add"] == before["add"] + 2
