"""The kernel of csrc/dfdot.cu against df.dot on a CUDA card, bit for bit.

Marked `card`: it skips where there is no CUDA card or no nvcc. It imports
no JAX, so on a machine with a card it runs on its own, without the JAX
settings of tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_dfdot_card.py
"""

import os
import shutil

import numpy as np
import pytest
import torch

from lilac_tpu_torch.kernels import dfdot as kd
from lilac_tpu_torch.ops import dfloat as df


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")
    if not (shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc")
            or os.environ.get("CUDA_HOME")):
        pytest.skip("needs nvcc to build csrc/dfdot.cu")


def _bits(d):
    return (d.hi.view(torch.int32).item(), d.lo.view(torch.int32).item())


@pytest.mark.card
@pytest.mark.parametrize("n", [1, 7, 4097, 9375, 150000, 150001, 1500000])
def test_dfdot_kernel_is_df_dot_bit_for_bit(n):
    _card()
    rng = np.random.default_rng(n)
    a = rng.standard_normal(n) * 10.0 ** rng.uniform(-6, 6, n)
    b = rng.standard_normal(n) * 10.0 ** rng.uniform(-6, 6, n)
    a[1::2] = -a[0:n - 1:2] * (1.0 + 1e-9)
    u, v = df.from_f64(a, "cuda"), df.from_f64(b, "cuda")
    before = kd.dfdot.launches
    got = kd.dfdot(u, v)
    want = df.dot(u, v)
    torch.cuda.synchronize()
    assert got.hi.shape == () and got.hi.is_cuda
    assert _bits(got) == _bits(want)
    depth = kd.kernel_depth(n, kd.device_sms(u.hi.device.index))
    assert kd.dfdot.launches - before == (2 if depth else 1)
    host = kd.dfdot_plain(df.DF(u.hi.cpu(), u.lo.cpu()),
                          df.DF(v.hi.cpu(), v.lo.cpu()), depth)
    assert _bits(got) == _bits(host)


@pytest.mark.card
def test_depth_is_the_librarys_function_of_n():
    """K from n and the SM count: 0 on one term, 5 at NPB classes C and D on
    an H100's 132 SMs, never decreasing in n, and n_K at least one."""
    _card()
    assert kd.kernel_depth(1, 132) == 0
    assert kd.kernel_depth(150000, 132) == 5 and kd.level_size(150000, 5) == 4688
    assert kd.kernel_depth(1500000, 132) == 5
    fill = 132 * 32
    assert kd.kernel_depth(2 * fill - 1, 132) == 1
    assert kd.kernel_depth(2 * fill - 2, 132) == 0
    last = 0
    for n in list(range(1, 3000, 7)) + [4223, 4224, 8447, 8448, 65536, 65537,
                                        150001, 1 << 20, 4096000, 10 ** 8, 2 ** 31]:
        K = kd.kernel_depth(n, 132)
        assert K >= last and kd.level_size(n, K) >= 1
        last = K
    with pytest.raises(ValueError):
        kd.kernel_depth(0, 132)


@pytest.mark.card
def test_dfdot_takes_strided_planes():
    _card()
    w = torch.arange(16, dtype=torch.float32, device="cuda")
    one = torch.ones(8, device="cuda")
    z = torch.zeros(8, device="cuda")
    got = kd.dfdot(df.DF(w[::2], z), df.DF(one, z))
    assert got.hi.item() == float(sum(range(0, 16, 2))) and got.lo.item() == 0.0
