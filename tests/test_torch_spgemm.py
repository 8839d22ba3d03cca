"""lilac_tpu_torch.ops.spgemm against the JAX package's, on the CPU.

* gustavson and expand_csr are host numpy: bit for bit, dtypes included.
* esc_spgemm (row groups sorted and segment-summed in torch) has the JAX
  package's structure exactly and its values to the JAX package's own
  tolerance (rtol 2e-5, atol 2e-6, tests/test_spmv.py): both sum f32
  products, in other orders. Forced to several groups by a small budget.
* masked_dense (one torch.matmul in f32) against jnp.dot's at rtol 1e-5,
  plus, where the sum cancels, what two f32 sums of k products may differ
  by: 2 (k + 2) 2^-24 (|A| |B|)_ij.
"""

import numpy as np
import pytest
import torch

from lilac_tpu.ops import spgemm as jsg
from lilac_tpu_torch.formats.convert import coo_to_csr_arrays
from lilac_tpu_torch.generate.random_crs import random_crs
from lilac_tpu_torch.ops import spgemm as tsg
from tests.conftest import random_csr

torch.set_num_threads(1)

CPU = "cpu"
ESC_TOL = dict(rtol=2e-5, atol=2e-6)  # tests/test_spmv.py's own


def _csr(rows, cols, vals, shape):
    return coo_to_csr_arrays(np.asarray(rows, np.int64), np.asarray(cols, np.int64),
                             np.asarray(vals, np.float64), shape), shape


def _case(name: str):
    """(a, shape_a, b, shape_b) of one edge case."""
    rng = np.random.default_rng(7)
    if name == "random":
        a = random_csr(rng, 120, 70, 0.08)
        b = random_csr(rng, 70, 90, 0.08)
    elif name == "empty_rows":  # every third row of A and of B holds nothing
        (ap, ai, av), sa = random_csr(rng, 90, 60, 0.1)
        keep = np.repeat(np.arange(90), np.diff(ap)) % 3 != 0
        a = _csr(np.repeat(np.arange(90), np.diff(ap))[keep], ai[keep], av[keep], sa)
        (bp, bi, bv), sb = random_csr(rng, 60, 75, 0.1)
        keep = np.repeat(np.arange(60), np.diff(bp)) % 3 != 1
        b = _csr(np.repeat(np.arange(60), np.diff(bp))[keep], bi[keep], bv[keep], sb)
    elif name == "no_entries":  # A only reaches B's empty rows
        a = _csr([0, 1, 3], [0, 2, 2], [1.0, 2.0, 3.0], (5, 4))
        b = _csr([1, 3], [0, 1], [4.0, 5.0], (4, 3))
    elif name == "ragged_chunk":  # 101 rows: not a multiple of the chunk
        a = random_csr(rng, 101, 40, 0.15)
        b = random_csr(rng, 40, 33, 0.2)
    else:  # the bench CLI's operands, at size 5
        a = random_crs(5, seed=3, mean_nnz=8, std_nnz=4)
        b = random_crs(5, seed=4, mean_nnz=8, std_nnz=4)
        return a[:3], a[3], b[:3], b[3]
    return a[0], a[1], b[0], b[1]


CASES = ("random", "empty_rows", "no_entries", "ragged_chunk", "random_crs")


def _same(u, v):
    assert len(u) == len(v)
    for x, y in zip(u, v):
        if isinstance(x, np.ndarray):
            assert x.dtype == np.asarray(y).dtype
            np.testing.assert_array_equal(x, y)
        else:
            assert tuple(x) == tuple(y)


@pytest.mark.parametrize("case", CASES)
def test_gustavson_and_expand_bit_for_bit(case):
    a, sa, b, sb = _case(case)
    _same(tsg.gustavson(a, b, sa, sb), jsg.gustavson(a, b, sa, sb))
    _same(tsg.expand_csr(a, b, sa, sb), jsg.expand_csr(a, b, sa, sb))


@pytest.mark.parametrize("case", CASES)
def test_esc_matches_the_jax_package(case):
    """row_chunk=32 and a budget of two chunks a group: several groups."""
    a, sa, b, sb = _case(case)
    ka = max(int(np.diff(a[0]).max()), 1)
    kb = max(int(np.diff(b[0]).max()), 1)
    budget = 2 * 32 * ka * kb * tsg.ESC_BYTES_PER_SLOT
    assert tsg.esc_group_rows(sa[0], ka, kb, budget, 32) == min(64, sa[0])
    got = tsg.esc_spgemm(a, b, sa, sb, row_chunk=32, device_budget_bytes=budget,
                         device=CPU)
    want = jsg.esc_spgemm(a, b, sa, sb, row_chunk=32)
    host = jsg.expand_csr(a, b, sa, sb)
    for ref in (want, host):
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
    assert got[2].dtype == want[2].dtype == np.float64
    np.testing.assert_allclose(got[2], want[2], **ESC_TOL)
    np.testing.assert_allclose(got[2], host[2], **ESC_TOL)
    assert got[3] == want[3]


def test_esc_groups_do_not_change_the_bits():
    """One group or a group a chunk: the same sums, bit for bit (a row's
    products meet in one group either way), and two runs agree."""
    a, sa, b, sb = _case("random")
    one = tsg.esc_spgemm(a, b, sa, sb, device=CPU)
    many = tsg.esc_spgemm(a, b, sa, sb, row_chunk=8, device_budget_bytes=1, device=CPU)
    again = tsg.esc_spgemm(a, b, sa, sb, row_chunk=8, device_budget_bytes=1, device=CPU)
    for u, v in ((one, many), (many, again)):
        _same(u[:2], v[:2])
        np.testing.assert_array_equal(u[2].view(np.uint64), v[2].view(np.uint64))


def test_esc_budget_rule():
    """The group size: budget over the ELL-padded slots a row, whole chunks,
    at least one chunk, at most the matrix; a quarter of the free memory on
    the card, ESC_HOST_BUDGET on the host."""
    assert tsg.esc_budget_bytes(CPU) == tsg.ESC_HOST_BUDGET
    per_row = 4 * 5 * tsg.ESC_BYTES_PER_SLOT
    assert tsg.esc_group_rows(10_000, 4, 5, 100 * per_row) == 100
    assert tsg.esc_group_rows(10_000, 4, 5, 100 * per_row, row_chunk=32) == 96
    assert tsg.esc_group_rows(10_000, 4, 5, 1, row_chunk=32) == 32
    assert tsg.esc_group_rows(50, 4, 5, 10**12) == 50


def _dense(a, shape):
    out = np.zeros(shape)
    out[np.repeat(np.arange(shape[0]), np.diff(a[0])), a[1]] = a[2]
    return out


@pytest.mark.parametrize("case", ("random", "empty_rows", "no_entries"))
def test_masked_dense_matches_the_jax_package(case):
    a, sa, b, sb = _case(case)
    got = tsg.masked_dense(a, b, sa, sb, device=CPU)
    want = jsg.masked_dense(a, b, sa, sb)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2].dtype == want[2].dtype
    A, B = _dense(a, sa), _dense(b, sb)
    rows = np.repeat(np.arange(sa[0]), np.diff(got[0]))
    k = ((A != 0) @ (B != 0).astype(np.float64))[rows, got[1]]
    slack = 2 * (k + 2) * 2.0**-24 * (np.abs(A) @ np.abs(B))[rows, got[1]]
    err = np.abs(got[2].astype(np.float64) - want[2])
    assert (err <= 1e-5 * np.abs(want[2]) + slack).all()
