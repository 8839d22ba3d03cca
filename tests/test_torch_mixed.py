"""The `mixed` factored layout of lilac_tpu_torch against the JAX package:
JagELLT (csr_sorted_to_jag_ellt, jag_ellt_spmv_df) and NPB class S with V
as a hierarchical routed plan and V^T as a gather layout.

Host arrays must be bit-identical. jag_ellt_spmv_df runs the reference's
chain (one pair-gather a diagonal, df.mul, df.add into the accumulator) in
eager torch where the reference runs it in a compiled lax.scan: held to
4e-14 relative to sum |a x| a row, the df64 tolerance of
tests/test_torch_segscan.py. The class S operator works in the
relabelled (sigma) space of the routed layouts, so its matvec on x[sigma]
is held to the JAX package's single-segment f64 gather operator's on x,
taken at sigma, to 1e-14 of sum |A| |x| in df64 and f64 (two summation
orders, and f64's own rounding), 1e-6 in f32.
"""

import os

import numpy as np
import pytest
import torch

from lilac_tpu.formats import convert as jconv
from lilac_tpu.generate import npb as jnpb
from lilac_tpu.kernels import factored as jfac
from lilac_tpu.kernels import xla as jxla
from lilac_tpu.ops import dfloat as jdf
from lilac_tpu_torch.config import cfg as tcfg
from lilac_tpu_torch.formats import convert as tconv
from lilac_tpu_torch.formats.sparse import JagELLT, SegBucketELL
from lilac_tpu_torch.kernels import factored as tfac
from lilac_tpu_torch.kernels import gather as tgather
from lilac_tpu_torch.kernels import routed_spmv as trs
from lilac_tpu_torch.ops import dfloat as tdf
from lilac_tpu_torch.workloads import npb_cg as trun

torch.set_num_threads(1)


def _sorted_csr(counts, seed):
    rng = np.random.default_rng(seed)
    n = len(counts)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    indices = rng.integers(0, n, size=int(indptr[-1])).astype(np.int64)
    data = rng.standard_normal(len(indices))
    return indptr, indices, data


def _counts(case):
    rng = np.random.default_rng(3)
    if case == "zero_tail":  # the reference's own case (tests/test_spmv.py)
        c = np.sort(rng.integers(0, 40, size=700))[::-1].copy()
        c[-5:] = 0
        return c, 4
    if case == "max_buckets":  # counts spread over 1..300: the 6th bucket takes the tail
        return np.sort(rng.integers(1, 300, size=900))[::-1].copy(), 6
    return np.zeros(50, np.int64), 6  # every row empty: zero buckets


@pytest.mark.parametrize("case", ["zero_tail", "max_buckets", "empty"])
def test_jag_ellt_arrays_and_product(case):
    counts, mb = _counts(case)
    n = len(counts)
    indptr, indices, data = _sorted_csr(counts, 7)
    pair = tdf.split_f64_np(data)
    J = jconv.csr_sorted_to_jag_ellt(indptr, indices, pair, (n, n), max_buckets=mb)
    T = tconv.csr_sorted_to_jag_ellt(indptr, indices, pair, (n, n), max_buckets=mb,
                                     device="cpu")
    assert isinstance(T, JagELLT) and T.row_counts == J.row_counts
    assert T.shape == tuple(J.shape) == (n, n)
    if case == "max_buckets":
        assert len(T.row_counts) == mb and sum(T.row_counts) == n
    elif case == "zero_tail":
        assert sum(T.row_counts) == np.count_nonzero(counts) < n
    else:
        assert T.row_counts == ()
    dh, dl, ix, rc = tconv.jag_ellt_arrays(indptr, indices, pair, (n, n), max_buckets=mb)
    assert tuple(rc) == J.row_counts
    for b in range(len(rc)):
        for t_arr, t_dev, j in ((dh[b], T.data_hi[b], J.data_hi[b]),
                                (dl[b], T.data_lo[b], J.data_lo[b]),
                                (ix[b], T.indices[b], J.indices[b])):
            j = np.asarray(j)
            assert t_arr.dtype == j.dtype
            np.testing.assert_array_equal(t_arr, j)
            np.testing.assert_array_equal(t_dev.numpy(), j)
    x = np.random.default_rng(11).standard_normal(n)
    yj = jdf.to_f64(jxla.jag_ellt_spmv_df(J, jdf.from_f64(x)))
    yt = tdf.to_f64(tgather.jag_ellt_spmv_df(T, tdf.from_f64(x, device="cpu")))
    assert yt.shape == (n,)
    rows = np.repeat(np.arange(n), counts)
    scale = np.bincount(rows, weights=np.abs(data * x[indices]), minlength=n)
    assert np.all(np.abs(yt - yj) <= 4e-14 * scale)
    exact = np.bincount(rows, weights=data * x[indices], minlength=n)
    assert np.all(np.abs(yt - exact) <= 1e-13 * scale)
    assert np.all(yt[counts == 0] == 0.0)


def test_jag_ellt_refuses_unsorted_rows():
    indptr, indices, data = _sorted_csr(np.array([1, 3, 2]), 1)
    with pytest.raises(ValueError, match="length-sorted"):
        tconv.csr_sorted_to_jag_ellt(indptr, indices, tdf.split_f64_np(data), (3, 3),
                                     device="cpu")


def test_mixed_modes_resolve_as_the_reference(monkeypatch):
    """mixed stays mixed with a V^T plan and is routed with adj (auto: adj
    beyond one table); the port never switches to mixed by itself."""
    monkeypatch.setenv("LILAC_FACTORED_SEGMODE", "mixed")
    assert tfac._resolve_modes(tcfg(), 1400, "cpu") == ("mixed", "plan")
    assert tfac._resolve_modes(tcfg(), 1_500_000, "cuda") == ("routed", "adj")
    monkeypatch.setenv("LILAC_FACTORED_VT", "plan")
    assert tfac._resolve_modes(tcfg(), 1_500_000, "cuda") == ("mixed", "plan")
    monkeypatch.setenv("LILAC_FACTORED_SEGMODE", "routed")
    assert tfac._resolve_modes(tcfg(), 9_000_000, "cuda") == ("routed", "plan")


def _sigma(cls_name):
    """The j-space relabel of the routed layouts: descending V-column
    multiplicity (kernels/factored.py)."""
    cls = jnpb.CLASSES[cls_name]
    _, ivc, _ = jnpb._generate_triples(cls)
    return np.argsort(-np.bincount(ivc - 1, minlength=cls.na), kind="stable")


@pytest.fixture
def jax_gather_s(monkeypatch, tmp_path):
    """The JAX package's single-segment gather operator of class S."""
    d = tmp_path / "jax"
    d.mkdir()
    monkeypatch.setenv("LILAC_DATA_DIR", str(d))
    monkeypatch.setenv("LILAC_FACTORED_SEGMODE", "single")

    def build(dtype):
        J, _ = jfac.build_factored("S", dtype=dtype)
        return J

    return build


def test_mixed_class_s_df64_verifies_and_matches_the_gather_operator(
        monkeypatch, tmp_path, jax_gather_s):
    J = jax_gather_s("f64")
    n = 1400
    sigma = _sigma("S")
    x = np.random.default_rng(5).standard_normal(n)
    yj, scale = _jax_products(J, x)  # A x and sum |A| |x|
    d = tmp_path / "torch"
    d.mkdir()
    monkeypatch.setenv("LILAC_DATA_DIR", str(d))
    monkeypatch.setenv("LILAC_FACTORED_SEGMODE", "mixed")
    r = trun.run("S", dtype="df64", device="cpu")
    assert r.verified and r.rel_err <= 1e-10
    assert r.kernel == "factored_mixed_df" and r.factored_vt == "plan"
    # V's hier plan file alone, under the hier tag; the second build loads it
    assert os.listdir(str(d)) == [
        f"routed2_S_df64_V{trs.plan_tag(tcfg(), hier=True)}.npz"]

    def no_build(*a, **k):
        raise AssertionError("V was rebuilt, not loaded")

    monkeypatch.setattr(tfac, "_build_hier_plan", no_build)
    A, nnz = tfac.build_factored("S", dtype="df64", device="cpu")
    assert isinstance(A.V, trs.RoutedMatHierP) and isinstance(A.VT, JagELLT)
    assert nnz == r.nnz
    yt = tdf.to_f64(tfac.factored_spmv_df(A, tdf.from_f64(x[sigma], device="cpu")))
    assert np.all(np.abs(yt - yj[sigma]) <= 1e-14 * scale[sigma])


def _jax_products(J, x):
    """A x and |A| |x| through the JAX package's operator, compiled (eager,
    its first product takes seconds on the CPU)."""
    import jax

    f = jax.jit(jfac.factored_spmv)
    return np.asarray(f(J, x)), np.asarray(f(jax_abs(J), np.abs(x)))


def jax_abs(J):
    """The JAX gather operator with |values|, |s| and |d0| (a bound of the
    summation error of A x)."""
    import dataclasses

    import jax.numpy as jnp

    def absd(c):
        return dataclasses.replace(c, data=tuple(jnp.abs(v) for v in c.data))

    return dataclasses.replace(J, V=absd(J.V), VT=absd(J.VT), s=jnp.abs(J.s),
                               d0=jnp.abs(J.d0))


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_mixed_class_s_plain_floats(dtype, monkeypatch, tmp_path, jax_gather_s):
    """In f32 / f64 mixed's V^T is a single-segment SegBucketELL; the
    product equals the gather operator's at sigma."""
    J = jax_gather_s("f64")
    n = 1400
    sigma = _sigma("S")
    x = np.random.default_rng(6).standard_normal(n)
    yj, scale = _jax_products(J, x)  # A x and sum |A| |x|
    d = tmp_path / "torch"
    d.mkdir()
    monkeypatch.setenv("LILAC_DATA_DIR", str(d))
    monkeypatch.setenv("LILAC_FACTORED_SEGMODE", "mixed")
    A, _ = tfac.build_factored("S", dtype=dtype, device="cpu")
    assert isinstance(A.V, trs.RoutedMatHierP) and isinstance(A.VT, SegBucketELL)
    xt = torch.as_tensor(x[sigma]).to(A.V.groups[0].vals.dtype)
    yt = tfac.factored_spmv(A, xt).double().numpy()
    tol = {"f32": 1e-6, "f64": 1e-14}[dtype]
    assert np.all(np.abs(yt - yj[sigma]) <= tol * scale[sigma])
