"""lilac_tpu_torch.kernels.dfops: the df64 algebra of the solvers at one
launch a call, on the CPU.

DF64Alg's add, sub, smul, sdiv and ssqrt hand float32 CUDA planes to the
kernels of csrc/dfops.cu and run the op chains of ops/dfloat.py on
everything else. Here, with no card: CPU planes never reach the CUDA
library and still give the JAX package's dfloat results bit for bit;
`_shape` takes 1-D planes of one length and 0-dim scalars and refuses
f64 planes, mismatched lengths, 2-D planes and mixed devices,
`result_shape` refuses every CPU operand, and the methods run the chain
where it refuses; and sdiv's zero numerator keeps its signed zero.
The kernels themselves are held to the chains on a card in
test_torch_dfops_card.py.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lilac_tpu.ops import dfloat as jdf
from lilac_tpu_torch.kernels import _cuda
from lilac_tpu_torch.kernels import dfops
from lilac_tpu_torch.ops import dfloat as tdf
from lilac_tpu_torch.solvers import algebra as talg

METHODS = ("add", "sub", "smul", "sdiv", "ssqrt")
# the JAX package's chain of each method
JAX = {"add": jdf.add, "sub": jdf.sub, "smul": jdf.mul, "sdiv": jdf.div,
       "ssqrt": jdf.sqrt}


def _values(n, seed):
    """n values over 12 decades, of either sign, none zero."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n) * 10.0 ** rng.uniform(-6, 6, n)


def _df(x):
    return tdf.from_f64(np.asarray(x, dtype=np.float64), device="cpu")


def _jdf(d):
    return jdf.DF(jnp.asarray(d.hi.numpy()), jnp.asarray(d.lo.numpy()))


def _bits(d):
    return (d.hi.view(torch.int32).tolist(), d.lo.view(torch.int32).tolist())


def _jbits(d):
    return (np.asarray(d.hi).view(np.int32).tolist(),
            np.asarray(d.lo).view(np.int32).tolist())


def _operands(method, n, seed):
    """What a solver hands the method: two vectors (add, sub), a scalar and
    a vector (smul), two scalars (sdiv) or a positive scalar (ssqrt); at
    n == 0 scalars only."""
    a, b = _values(max(n, 1), seed), _values(max(n, 1), seed + 1)
    if method in ("add", "sub") and n:
        return _df(a), _df(b)
    if method == "smul" and n:
        return _df(a[0]), _df(b)
    if method == "ssqrt":
        return (_df(abs(a[0])),)
    return _df(a[0]), _df(b[0])


@pytest.fixture
def no_cuda_library(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("CUDA library touched for a CPU tensor")

    monkeypatch.setattr(_cuda, "load", boom)
    monkeypatch.setattr(_cuda, "build_all", boom)
    before = dict(dfops.launches)
    yield
    assert dfops.launches == before


@pytest.mark.parametrize("n", [0, 1, 7, 4097])
@pytest.mark.parametrize("method", METHODS)
def test_cpu_planes_take_the_chain_and_give_the_jax_result(no_cuda_library, method, n):
    args = _operands(method, n, 11 * n + len(method))
    got = getattr(talg.DF64Alg(device="cpu"), method)(*args)
    want = JAX[method](*(_jdf(a) for a in args))
    assert _bits(got) == _jbits(want)
    assert dfops.result_shape(*args) is None


@pytest.mark.parametrize("method", ["add", "sub", "smul", "sdiv"])
def test_cpu_vectors_every_method_elementwise_is_the_jax_chain(no_cuda_library, method):
    """Elementwise over 4097 pairs, so that sdiv and smul meet many values
    (the kernels take these shapes too)."""
    u, v = _df(_values(4097, 1)), _df(_values(4097, 2))
    got = getattr(talg.DF64Alg(device="cpu"), method)(u, v)
    assert _bits(got) == _jbits(JAX[method](_jdf(u), _jdf(v)))


def _df_operands(planes):
    """The df operands whose planes are given in turn."""
    return [tdf.DF(planes[i], planes[i + 1]) for i in range(0, len(planes), 2)]


def _accepted():
    vec, sca = torch.ones(5), torch.ones(())
    return [
        ((vec, vec, vec, vec), (5,)),
        ((sca, sca, vec, vec), (5,)),
        ((vec, vec, sca, sca), (5,)),
        ((sca, sca, sca, sca), ()),
        ((sca, sca), ()),
        ((vec, vec), (5,)),
    ]


@pytest.mark.parametrize("case", range(6))
def test_shape_takes_vectors_of_one_length_and_scalars(case):
    planes, shape = _accepted()[case]
    assert dfops._shape(*planes) == shape
    # a CPU plane is never the kernels': the chain is the arithmetic there
    assert dfops.result_shape(*_df_operands(planes)) is None


def _refused():
    v, z = torch.ones(8), torch.zeros(8)
    return {
        "f64": (v.double(), z.double(), v.double(), z.double()),
        "f64_lo": (v, z.double(), v, z),
        "lengths": (v, z, v[:7], z[:7]),
        "2-D": (v.view(2, 4), z.view(2, 4), v.view(2, 4), z.view(2, 4)),
        "2-D_scalar": (torch.ones(()), torch.zeros(()), v.view(2, 4), z.view(2, 4)),
        "devices": (v, z, torch.ones(8, device="meta"), torch.zeros(8, device="meta")),
        "empty": (v[:0], z[:0], v[:0], z[:0]),
        "hi_lo_dims": (v[:1], torch.zeros(()), v[:1], z[:1]),
    }


@pytest.mark.parametrize("kind", list(_refused()))
def test_shape_refuses_what_the_kernels_do_not_take(kind):
    planes = _refused()[kind]
    assert dfops._shape(*planes) is None
    assert dfops.result_shape(*_df_operands(planes)) is None
    with pytest.raises(ValueError, match="CUDA"):
        dfops.add(tdf.DF(*planes[:2]), tdf.DF(*planes[2:]))


@pytest.mark.parametrize("method", ["add", "sub", "smul"])
@pytest.mark.parametrize("kind", ["f64", "2-D"])
def test_methods_run_the_chain_on_planes_the_kernels_refuse(no_cuda_library, method, kind):
    u = tdf.from_f64(_values(8, 3), device="cpu")
    v = tdf.from_f64(_values(8, 4), device="cpu")
    if kind == "f64":
        u, v = (tdf.DF(d.hi.double(), d.lo.double()) for d in (u, v))
    else:
        u, v = (tdf.DF(d.hi.view(2, 4), d.lo.view(2, 4)) for d in (u, v))
    chain = {"add": tdf.add, "sub": tdf.sub, "smul": tdf.mul}[method]
    got = getattr(talg.DF64Alg(device="cpu"), method)(u, v)
    want = chain(u, v)
    assert got.hi.dtype == u.hi.dtype and got.hi.shape == u.hi.shape
    assert torch.equal(got.hi, want.hi) and torch.equal(got.lo, want.lo)


@pytest.mark.parametrize("kind", ["lengths", "devices"])
def test_methods_on_mismatched_planes_raise_as_the_chain_does(no_cuda_library, kind):
    planes = _refused()[kind]
    u, v = tdf.DF(*planes[:2]), tdf.DF(*planes[2:])
    with pytest.raises(RuntimeError):
        tdf.add(u, v)
    with pytest.raises(RuntimeError):
        talg.DF64Alg(device="cpu").add(u, v)


@pytest.mark.parametrize("den", [0.0, -0.0, 2.5, -3e-40, 7e30])
@pytest.mark.parametrize("num", [0.0, -0.0])
def test_sdiv_of_a_zero_numerator_keeps_its_signed_zero(no_cuda_library, num, den):
    scalar = lambda v: tdf.DF(torch.tensor(np.float32(v)), torch.tensor(np.float32(0.0)))  # noqa: E731
    a = scalar(num)
    got = talg.DF64Alg(device="cpu").sdiv(a, scalar(den))
    assert _bits(got) == _bits(tdf.DF(a.hi, a.hi))
    assert str(got.hi.item()) == str(num) and str(got.lo.item()) == str(num)


def test_launch_counter_names_every_entry():
    assert set(dfops.launches) == {"add", "sub", "mul", "div", "sqrt"}
    assert "dfops" in _cuda.SOURCES


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("maxit", [1, 3, 100])
def test_bicg_calls_each_method_as_the_card_smoke_counts_launches(maxit):
    """chip_smoke.py holds dfops's launches in a SparseBench solve to
    `_sb_dfops(its)`: here bicg_solve's calls of each DF64Alg method, on a
    well-conditioned system that converges within 100 iterations and not
    within 1 or 3, are exactly that count."""
    from lilac_tpu_torch.solvers.bicg import bicg_solve

    entry = {"add": "add", "sub": "sub", "smul": "mul", "sdiv": "div", "ssqrt": "sqrt"}
    calls = dict.fromkeys(entry.values(), 0)

    class Counting(talg.DF64Alg):
        pass

    for method, name in entry.items():
        def counted(self, *args, _f=getattr(talg.DF64Alg, method), _name=name):
            calls[_name] += 1
            return _f(self, *args)
        setattr(Counting, method, counted)

    rng = np.random.default_rng(5)
    A = 4 * np.eye(30) + 0.1 * rng.standard_normal((30, 30))
    f64 = lambda d: d.hi.double().numpy() + d.lo.double().numpy()  # noqa: E731
    _, its, _, _, _ = bicg_solve(
        lambda _, x: _df(A @ f64(x)), lambda _, x: _df(A.T @ f64(x)),
        Counting(device="cpu"), None, _df(np.ones(30)), _df(np.zeros(30)),
        maxit=maxit, rtol=1e-6)
    assert (its > 0) == (maxit == 100)
    assert calls == _chip_smoke()._sb_dfops(its)
