"""The column-segmented gather layouts of lilac_tpu_torch against the JAX
package: SegELLScan (csr_to_seg_ell_scan, xla_segscan / xla_segscan_df),
multi-segment SegBucketELL, SlicedELL, and the factored operator's `scan`
mode at NPB class S.

Host arrays must be bit-identical. Products are compared with the value
policy's tolerance relative to sum |a x| a row: 1e-13 in f64 and 4e-14 in
df64 (the reference accumulates the segments inside lax.scan, compiled,
the port segment by segment in eager torch; the df64 arithmetic is the
same chain of df.mul / df.sum_df / df.add).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lilac_tpu.formats import convert as jconv
from lilac_tpu.kernels import factored as jfac
from lilac_tpu.kernels import xla as jxla
from lilac_tpu.ops import dfloat as jdf
from lilac_tpu_torch import plan as tplan
from lilac_tpu_torch.config import cfg as tcfg
from lilac_tpu_torch.formats import convert as tconv
from lilac_tpu_torch.formats.sparse import SegELLScan, SlicedELL
from lilac_tpu_torch.kernels import factored as tfac
from lilac_tpu_torch.kernels import gather as tgather
from lilac_tpu_torch.kernels.registry import get_kernel
from lilac_tpu_torch.ops import dfloat as tdf
from lilac_tpu_torch.workloads import npb_cg as trun

torch.set_num_threads(1)

TOL = {"f64": 1e-13, "df64": 4e-14}

# the reference tests' own cases (tests/test_spmv.py): rows (= columns),
# density, seg_size, seg_quantile
SCAN_CASES = (
    (200, 0.05, 64, 70.0),   # 4 segments and a tail
    (100, 0.05, 40, 100.0),  # 3 segments, no tail
    (150, 0.06, 50, 80.0),   # 3 segments
)


def _matrix(n, density, seed=1234):
    from tests.conftest import random_csr

    (indptr, indices, data), shape = random_csr(np.random.default_rng(seed), n, n, density)
    return indptr, indices, data, shape


def _vals(data, dtype):
    return tdf.split_f64_np(data) if dtype == "df64" else data


def _scale(indptr, indices, data, x):
    rows = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
    return np.bincount(rows, weights=np.abs(data * x[indices]), minlength=len(indptr) - 1)


def _products(jfn, tfn, J, T, x, dtype):
    if dtype == "df64":
        yj = jdf.to_f64(jfn(J, jdf.from_f64(x)))
        yt = tdf.to_f64(tfn(T, tdf.from_f64(x, device="cpu")))
    else:
        yj = np.asarray(jfn(J, jnp.asarray(x)))
        yt = tfn(T, torch.as_tensor(x)).numpy()
    return yj, yt


@pytest.mark.parametrize("dtype", ["f64", "df64"])
@pytest.mark.parametrize("case", SCAN_CASES)
def test_seg_ell_scan_arrays_and_product(case, dtype):
    n, density, seg_size, q = case
    indptr, indices, data, shape = _matrix(n, density)
    vals = _vals(data, dtype)
    J = jconv.csr_to_seg_ell_scan(indptr, indices, vals, shape, seg_size=seg_size,
                                  seg_quantile=q)
    T = tconv.csr_to_seg_ell_scan(indptr, indices, vals, shape, seg_size=seg_size,
                                  seg_quantile=q, device="cpu")
    assert isinstance(T, SegELLScan)
    assert (T.shape, T.seg_size, T.nseg, T.width) == (J.shape, J.seg_size, J.nseg, J.width)
    assert T.nseg == -(-n // seg_size) > 1
    assert (T.tail_data is None) == (J.tail_data is None) == (q == 100.0)
    for f in ("main_data", "main_indices", "tail_data", "tail_indices", "tail_pos"):
        a, b = getattr(J, f), getattr(T, f)
        if a is None:
            continue
        assert b.dtype == (torch.int64 if "data" not in f else b.dtype)
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    x = np.random.default_rng(7).standard_normal(n)
    jfn = jxla.seg_ell_scan_spmv_df if dtype == "df64" else jxla.seg_ell_scan_spmv
    tfn = get_kernel("xla_segscan_df" if dtype == "df64" else "xla_segscan").fn
    yj, yt = _products(jfn, tfn, J, T, x, dtype)
    scale = _scale(indptr, indices, data, x)
    assert np.all(np.abs(yt - yj) <= TOL[dtype] * scale)
    dense = np.zeros(shape)
    dense[np.repeat(np.arange(n), np.diff(indptr)), indices] = data
    assert np.all(np.abs(yt - dense @ x) <= TOL[dtype] * scale)


@pytest.mark.parametrize("dtype", ["f64", "df64"])
@pytest.mark.parametrize("seg_size,seg_quantile", [(50, 95.0), (64, 70.0), (37, 50.0)])
def test_multiseg_seg_bucket_ell(seg_size, seg_quantile, dtype):
    """Several segments: a main part a segment (local indices) and a tail
    (segment -1, global indices), the reference's arrays and parts bit for
    bit; the products equal to the policy's tolerance."""
    indptr, indices, data, shape = _matrix(150, 0.06)
    vals = _vals(data, dtype)
    J = jconv.csr_to_seg_bucket_ell(indptr, indices, vals, shape, seg_size=seg_size,
                                    seg_quantile=seg_quantile)
    T = tconv.csr_to_seg_bucket_ell(indptr, indices, vals, shape, seg_size=seg_size,
                                    seg_quantile=seg_quantile, device="cpu")
    assert tuple(J.parts) == T.parts and J.identity_perm == T.identity_perm is True
    assert J.seg_size == T.seg_size and any(p[2] == -1 for p in T.parts)
    assert [p[2] for p in T.parts if p[2] >= 0] == list(range(-(-150 // seg_size)))
    np.testing.assert_array_equal(np.asarray(J.inv_perm), T.inv_perm.numpy())
    for a, b in zip(J.data + J.indices, T.data + T.indices):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    x = np.random.default_rng(8).standard_normal(150)
    jfn = jxla.seg_bucket_ell_spmv_df if dtype == "df64" else jxla.seg_bucket_ell_spmv
    tfn = tgather.seg_bucket_ell_spmv_df if dtype == "df64" else tgather.seg_bucket_ell_spmv
    yj, yt = _products(jfn, tfn, J, T, x, dtype)
    assert np.all(np.abs(yt - yj) <= TOL[dtype] * _scale(indptr, indices, data, x))


def test_converter_defaults_are_the_reference():
    """The same call builds the same arrays: seg_size 163840 and the
    quantiles by default (one segment below 163840 columns)."""
    indptr, indices, data, shape = _matrix(120, 0.08)
    J = jconv.csr_to_seg_bucket_ell(indptr, indices, data, shape)
    T = tconv.csr_to_seg_bucket_ell(indptr, indices, data, shape, device="cpu")
    assert tuple(J.parts) == T.parts and T.seg_size == J.seg_size == 163840
    Js = jconv.csr_to_seg_ell_scan(indptr, indices, data, shape)
    Ts = tconv.csr_to_seg_ell_scan(indptr, indices, data, shape, device="cpu")
    assert (Ts.seg_size, Ts.nseg, Ts.width) == (Js.seg_size, Js.nseg, Js.width)
    np.testing.assert_array_equal(np.asarray(Js.main_indices), Ts.main_indices.numpy())


@pytest.mark.parametrize("n,m,density,height", [(57, 43, 0.1, 8), (200, 150, 0.05, 8),
                                                (99, 99, 0.2, 4), (5, 7, 0.3, 32)])
def test_sliced_ell_bit_identical(n, m, density, height):
    from tests.conftest import random_csr

    (indptr, indices, data), shape = random_csr(np.random.default_rng(n), n, m, density)
    ref = jconv.csr_to_sliced_ell_arrays(indptr, indices, data, shape, slice_height=height)
    got = tconv.csr_to_sliced_ell_arrays(indptr, indices, data, shape, slice_height=height)
    for a, b in zip(ref, got):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    S = tconv.sliced_ell_device(indptr, indices, data, shape, slice_height=height,
                                device="cpu")
    assert isinstance(S, SlicedELL) and S.slice_height == height and S.shape == shape
    np.testing.assert_array_equal(S.data.numpy(), ref[0])
    np.testing.assert_array_equal(S.row_starts.numpy(), ref[2])


def test_factored_scan_mode_at_class_s(monkeypatch, tmp_path):
    """The port's factored operator in `scan` mode (forced to several
    segments, SEG_SIZE 500) equals its `single` build, as the reference's
    test_factored_scan_mode_matches_single_seg holds it, and its containers
    and matvec equal the reference's scan-mode operator on one x."""
    monkeypatch.setenv("LILAC_DATA_DIR", str(tmp_path))
    monkeypatch.setenv("LILAC_FACTORED_SEGMODE", "single")
    A1, _ = tfac.build_factored("S", dtype="f64", device="cpu")
    monkeypatch.setenv("LILAC_FACTORED_SEGMODE", "scan")
    monkeypatch.setattr(tfac, "SEG_SIZE", 500)
    monkeypatch.setattr(jfac, "SEG_SIZE", 500)
    assert tfac._resolve_modes(tcfg(), 1400, "cpu") == ("scan", "plan")
    A2, nnz = tfac.build_factored("S", dtype="f64", device="cpu")
    J, jnnz = jfac.build_factored("S", dtype="f64")
    assert nnz == jnnz
    assert isinstance(A2.V, SegELLScan) and A2.V.nseg == 3 and isinstance(A2.VT, SegELLScan)
    for t, j in ((A2.V, J.V), (A2.VT, J.VT)):
        assert (t.nseg, t.width) == (j.nseg, j.width)
        np.testing.assert_array_equal(t.main_indices.numpy(), np.asarray(j.main_indices))
        np.testing.assert_array_equal(t.main_data.numpy(), np.asarray(j.main_data))
    x = np.random.default_rng(0).standard_normal(1400)
    y1 = tfac.factored_spmv(A1, torch.as_tensor(x)).numpy()
    y2 = tfac.factored_spmv(A2, torch.as_tensor(x)).numpy()
    yj = np.asarray(jfac.factored_spmv(J, jnp.asarray(x)))
    np.testing.assert_allclose(y2, y1, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(y2, yj, rtol=1e-13, atol=1e-13 * np.abs(yj).max())


@pytest.mark.parametrize("dtype", ["f32", "df64"])
def test_factored_scan_mode_npb_class_s(dtype, monkeypatch, tmp_path):
    """Three outer steps of class S through the scan layout at the default
    SEG_SIZE (one segment) and at 500 (three): the zeta histories agree with
    the single-segment gather layout's (f32: 1e-5, df64: 1e-12)."""
    monkeypatch.setenv("LILAC_DATA_DIR", str(tmp_path))
    monkeypatch.setenv("LILAC_FACTORED_SEGMODE", "single")
    ref = trun.run("S", dtype=dtype, niter=3, device="cpu")
    monkeypatch.setenv("LILAC_FACTORED_SEGMODE", "scan")
    tol = 1e-5 if dtype == "f32" else 1e-12
    for seg in (tfac.SEG_SIZE, 500):
        monkeypatch.setattr(tfac, "SEG_SIZE", seg)
        r = trun.run("S", dtype=dtype, niter=3, device="cpu")
        assert r.kernel == "factored_gather" + ("_df" if dtype == "df64" else "")
        rel = np.abs(r.zeta_history - ref.zeta_history) / np.abs(ref.zeta_history)
        assert rel.max() <= tol, (seg, rel)


def test_segscan_is_not_an_spmv_plan_kernel():
    """As in the reference, xla_segscan is reached through the factored
    `scan` mode and by direct calls, never through SpmvPlan."""
    indptr, indices, data, shape = _matrix(60, 0.1)
    assert get_kernel("xla_segscan").container is SegELLScan
    for kernel in ("xla_segscan", "xla_segscan_df"):
        with pytest.raises(ValueError, match="not wired into SpmvPlan"):
            tplan.SpmvPlan(indptr, indices, data, shape, kernel=kernel, device="cpu")
