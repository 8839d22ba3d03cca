"""The yardstick without the program: the frozen makea, the plain power
iteration, the byte count of the roofline and the trace reductions."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pb_support import BENCH, REPO
from portbench.reference import npb
from portbench.yardstick import roofline
from portbench.yardstick.trace import Trace, idle_gaps, top_device_ops, union_seconds

S = npb.NPBClass("S", 1400, 7, 15, 10.0, 0.1, 8.5971775078648)
W = npb.NPBClass("W", 7000, 8, 15, 12.0, 0.1, 10.362595087124)
A = npb.NPBClass("A", 14000, 11, 15, 20.0, 0.1, 17.130235054029)


@pytest.mark.parametrize("cls", [S, W, A], ids=lambda c: c.name)
def test_makea_blocks_equal_the_loop(cls):
    fast = npb.makea_triples(cls.na, cls.nonzer, pairs_per_block=1 << 11)
    loop = npb.makea_triples_loop(cls.na, cls.nonzer)
    for a, b in zip(fast, loop):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cls", [S, W], ids=lambda c: c.name)
def test_published_zeta_from_ones(cls):
    """NPB's verification: the untimed step, then niter steps from the
    all-ones vector, zeta within 1e-10 of the published value."""
    op = npb.Operator(cls, npb.makea_triples(cls.na, cls.nonzer), "cpu")
    x0 = torch.ones(cls.na, dtype=torch.float64)
    zetas, rnorms, _ = npb.power_method(op, x0, cls.shift, cls.niter)
    assert abs(zetas[-1] - cls.zeta_verify) / cls.zeta_verify <= 1e-10
    assert np.all(rnorms < 1e-12)


def test_relabel_orders_columns_by_count():
    ivc = np.array([3, 3, 1, 2, 3, 1]) + 0
    assert list(npb.relabel(ivc, 4)) == [2, 0, 1, 3]


def test_roofline_bytes_by_hand():
    """V with rows of 2 and 3 entries in f64: 5 entries of 8 + 4 bytes, 3
    row pointers of 4, s, x and y of 2 doubles each."""
    assert roofline.factored_spmv_bytes(np.array([2, 3]), 8) == 5 * 12 + 3 * 4 + 3 * 2 * 8


def test_union_and_top_ops():
    ops = [("k1", 0.0, 2.0), ("k2", 1.0, 3.0), ("k1", 5.0, 6.0)]
    assert union_seconds(ops) == pytest.approx(4.0)
    t = Trace(ops, [], {}, 6.0)
    assert top_device_ops(t) == [["k1", 3.0], ["k2", 2.0]]


def test_idle_gaps_are_labelled_by_the_innermost_host_op():
    dev = [("k", 0.0, 1.0), ("k", 2.0, 3.0), ("k", 6.0, 7.0)]
    host = [("outer", 0.0, 7.0), ("aten::add", 1.2, 1.9), ("sync", 3.5, 5.5)]
    gaps = idle_gaps(Trace(dev, host, {}, 7.0))
    assert gaps == [["sync", 3.0], ["aten::add", 1.0]]
    assert idle_gaps(Trace(dev, [], {}, 7.0)) == [["host", 4.0]]


def test_the_reference_loads_nothing_of_the_program():
    """The reference runs with no module of the measured program, of the
    JAX package or of JAX loaded, and its sources name none of them."""
    code = "\n".join([
        "import sys, torch",
        f"sys.path.insert(0, {REPO!r})",
        "from portbench.reference import npb",
        "c = npb.NPBClass('S', 1400, 7, 15, 10.0, 0.1, 8.5971775078648)",
        "op = npb.Operator(c, npb.makea_triples(c.na, c.nonzer), 'cpu')",
        "npb.power_method(op, torch.ones(c.na, dtype=torch.float64), c.shift, 1)",
        "print(sorted({m.split('.')[0] for m in sys.modules}))",
    ])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd="/").stdout
    tops = set(eval(out.strip().splitlines()[-1]))
    assert not tops & {"lilac_tpu_torch", "lilac_tpu", "jax", "jaxlib", "flax"}
    ref_dir = os.path.join(BENCH, "reference")
    for name in os.listdir(ref_dir):
        if name.endswith(".py"):
            with open(os.path.join(ref_dir, name)) as f:
                assert "lilac_tpu" not in f.read()
