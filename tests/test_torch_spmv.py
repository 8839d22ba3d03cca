"""lilac_tpu_torch sparse front end against the JAX package: converters,
gather kernels and their registry, ops.spmv, SpmvPlan and the bench CSV
analysis.

Host arrays of the converters must be bit-identical. Products are compared
on the SAME container (the JAX one's fields handed over through
convert_reference) with the tolerance of the value policy, relative to
sum |a·x| per output: 1e-6 in f32, 1e-12 in f64, 2^-46 in df64, 1e-2 in
bf16 (summation orders differ between XLA and torch).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lilac_tpu import bench as jbench
from lilac_tpu import plan as jplan
from lilac_tpu.formats import convert as jconv
from lilac_tpu.generate import random_crs as jrc
from lilac_tpu.ops import dfloat as jdf
from lilac_tpu.ops.spmv import spmm as jspmm, spmv as jspmv, spmv_t as jspmv_t
from lilac_tpu_torch import bench as tbench
from lilac_tpu_torch import convert_reference as cr
from lilac_tpu_torch import plan as tplan
from lilac_tpu_torch.formats import convert as tconv
from lilac_tpu_torch.kernels.registry import KERNELS, get_kernel
from lilac_tpu_torch.ops import dfloat as tdf
from lilac_tpu_torch.ops import spmv as tops

torch.set_num_threads(1)

TOL = {"f32": 1e-6, "f64": 1e-12, "df64": 2.0 ** -46, "bf16": 1e-2}
GATHER = ("xla_csr", "xla_coo", "xla_ell", "xla_ell_df", "xla_bsr", "xla_sell",
          "xla_sell_df")


def _csr(seed, n=300, ncol=257, kmax=9, dense_col=True, spread=True):
    """Seeded CSR with empty rows, a column in most rows and (spread) a few
    long rows; canonical (sorted, no duplicates)."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, kmax + 1, size=n)
    counts[rng.choice(n, size=n // 10, replace=False)] = 0  # empty rows
    if spread:
        counts[rng.choice(n, size=3, replace=False)] = ncol // 3
    rows, cols = [], []
    for r, k in enumerate(counts):
        c = rng.choice(ncol, size=k, replace=False)
        if dense_col and r % 4 != 3 and k:
            c[0] = 5
            c = np.unique(c)
        rows.append(np.full(len(c), r))
        cols.append(c)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    vals = rng.standard_normal(len(rows))
    ip, ix, dv = jconv.coo_to_csr_arrays(rows, cols, vals, (n, ncol))
    return ip, ix, dv, (n, ncol)


def _scale(ip, ix, dv, shape, x, transpose=False):
    """sum |a_ij x_j| per output row (per column for the transpose)."""
    rows = np.repeat(np.arange(shape[0]), np.diff(ip))
    out_idx, in_idx = (ix, rows) if transpose else (rows, ix)
    return np.bincount(out_idx, weights=np.abs(dv * x[in_idx]),
                       minlength=shape[1] if transpose else shape[0])


def _close(got, want, scale, tol, what=""):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    bad = err > tol * scale + 1e-300
    assert not bad.any(), f"{what}: max err/scale {np.max(err / np.maximum(scale, 1e-300))}"


def _np(a):
    return None if a is None else np.asarray(a)


def _to_port(A):
    """The JAX container A rebuilt as the port's, on the CPU."""
    from lilac_tpu.formats import sparse as js

    if isinstance(A, js.CSR):
        return cr.csr_from_arrays(_np(A.data), _np(A.indices), _np(A.indptr), A.shape,
                                  _np(A.row_ids), device="cpu")
    if isinstance(A, js.COO):
        return cr.coo_from_arrays(_np(A.row), _np(A.col), _np(A.data), A.shape,
                                  device="cpu")
    if isinstance(A, js.ELL):
        return cr.ell_from_arrays(_np(A.data), _np(A.indices), A.shape, device="cpu")
    if isinstance(A, js.BSR):
        return cr.bsr_from_arrays(_np(A.data), _np(A.indices), _np(A.indptr), A.shape,
                                  A.block_shape, device="cpu")
    if isinstance(A, js.BucketELL):
        return cr.bucket_ell_from_arrays([_np(v) for v in A.data],
                                         [_np(i) for i in A.indices],
                                         _np(A.inv_perm), A.shape, A.widths,
                                         device="cpu")
    raise TypeError(type(A))


# -- converters: bit-identical host arrays ------------------------------------


def _eq(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("conv,df64", [
    (c, d) for c in ("ell", "ell_pad", "bsr", "bsr_small", "bucket", "bucket_q")
    for d in (False, True) if not (d and c.startswith("bsr"))])  # BSR: plain floats
def test_converters_bit_identical(seed, df64, conv):
    ip, ix, dv, shape = _csr(seed)
    data = tdf.split_f64_np(dv) if df64 else dv
    if conv.startswith("ell"):
        kw = dict(row_pad=16, slot_pad=4) if conv == "ell_pad" else {}
        for a, b in zip(jconv.csr_to_ell_arrays(ip, ix, data, shape, **kw),
                        tconv.csr_to_ell_arrays(ip, ix, data, shape, **kw)):
            _eq(a, b)
    elif conv.startswith("bsr"):
        bs = (4, 4) if conv == "bsr_small" else (8, 128)
        for a, b in zip(jconv.csr_to_bsr_arrays(ip, ix, data, shape, bs),
                        tconv.csr_to_bsr_arrays(ip, ix, data, shape, bs)):
            _eq(a, b)
    else:
        q = (25, 75, 95) if conv == "bucket_q" else (50, 90)
        ja = jconv.csr_to_bucket_ell_arrays(ip, ix, data, shape, quantiles=q)
        ta = tconv.csr_to_bucket_ell_arrays(ip, ix, data, shape, quantiles=q)
        assert ja[3] == ta[3] and len(ja[0]) == len(ta[0]) > 1
        for la, lb in zip(ja[:2], ta[:2]):
            for a, b in zip(la, lb):
                _eq(a, b)
        _eq(ja[2], ta[2])


def test_dense_to_csr_and_round_up_bit_identical():
    rng = np.random.default_rng(3)
    dense = rng.standard_normal((40, 33))
    dense[np.abs(dense) < 0.8] = 0.0
    dense[7] = 0.0  # an empty row
    for tol in (0.0, 1.2):
        for a, b in zip(jconv.dense_to_csr_arrays(dense, tol),
                        tconv.dense_to_csr_arrays(dense, tol)):
            _eq(a, b)
    assert [tconv.round_up(v, 8) for v in (0, 1, 8, 9)] == [
        jconv.round_up(v, 8) for v in (0, 1, 8, 9)]


@pytest.mark.parametrize("kind", ["csr", "coo", "ell", "bsr", "bucket"])
def test_device_wrappers_match_reference_containers(kind):
    ip, ix, dv, shape = _csr(4)
    rows = np.repeat(np.arange(shape[0]), np.diff(ip))
    if kind == "csr":
        J = jconv.csr_device(ip, ix, dv, shape, dtype=np.float32)
        T = tconv.csr_device(ip, ix, dv, shape, dtype=np.float32, device="cpu")
        pairs = [(J.data, T.data), (J.indices, T.indices), (J.indptr, T.indptr),
                 (J.row_ids, T.row_ids)]
    elif kind == "coo":
        J = jconv.coo_device(rows, ix, dv, shape)
        T = tconv.coo_device(rows, ix, dv, shape, device="cpu")
        pairs = [(J.row, T.row), (J.col, T.col), (J.data, T.data)]
    elif kind == "ell":
        J = jconv.ell_device(ip, ix, dv, shape, row_pad=8)
        T = tconv.ell_device(ip, ix, dv, shape, row_pad=8, device="cpu")
        pairs = [(J.data, T.data), (J.indices, T.indices)]
    elif kind == "bsr":
        J = jconv.bsr_device(ip, ix, dv, shape, (8, 16))
        T = tconv.bsr_device(ip, ix, dv, shape, (8, 16), device="cpu")
        pairs = [(J.data, T.data), (J.indices, T.indices), (J.indptr, T.indptr)]
        assert J.block_shape == T.block_shape
    else:
        J = jconv.bucket_ell_device(ip, ix, dv, shape)
        T = tconv.bucket_ell_device(ip, ix, dv, shape, device="cpu")
        pairs = list(zip(J.data, T.data)) + list(zip(J.indices, T.indices))
        pairs.append((J.inv_perm, T.inv_perm))
        assert J.widths == T.widths
    assert tuple(J.shape) == T.shape
    for j, t in pairs:
        np.testing.assert_array_equal(np.asarray(j), t.numpy())


# -- gather kernels against lilac_tpu.kernels.xla on the same container -------


def _jax_container(name, ip, ix, dv, shape, dtype):
    jt = {"f32": np.float32, "f64": np.float64}.get(dtype)
    rows = np.repeat(np.arange(shape[0]), np.diff(ip))
    if name == "xla_csr":
        return jconv.csr_device(ip, ix, dv, shape, dtype=jt)
    if name == "xla_coo":
        return jconv.coo_device(rows, ix, dv, shape, dtype=jt)
    if name == "xla_ell":
        return jconv.ell_device(ip, ix, dv, shape, dtype=jt)
    if name == "xla_bsr":
        return jconv.bsr_device(ip, ix, dv, shape, (8, 16), dtype=jt)
    if name == "xla_sell":
        return jconv.bucket_ell_device(ip, ix, dv, shape, dtype=jt)
    vals = jdf.split_f64_np(dv)
    if name == "xla_ell_df":
        v, c = jconv.csr_to_ell_arrays(ip, ix, vals, shape, row_pad=8)
        from lilac_tpu.formats.sparse import ELL

        return ELL(data=jnp.asarray(v), indices=jnp.asarray(c), shape=shape)
    return jconv.bucket_ell_device(ip, ix, vals, shape)


@pytest.mark.parametrize("name,dtype", [
    (n, d) for n in GATHER for d in ("f32", "f64")
    if not (n.endswith("_df") and d == "f32")])  # df64 kernels: one policy
def test_gather_kernel_matches_reference(name, dtype):
    from lilac_tpu.kernels.registry import get_kernel as jget

    entry = get_kernel(name)
    ip, ix, dv, shape = _csr(7)
    rng = np.random.default_rng(8)
    x = rng.standard_normal(shape[1])
    u = rng.standard_normal(shape[0])
    J = _jax_container(name, ip, ix, dv, shape, dtype)
    T = _to_port(J)
    assert isinstance(T, entry.container)
    je = jget(name)
    if entry.dfloat:
        got = tdf.to_f64(entry.fn(T, tdf.from_f64(x, device="cpu")))
        want = jdf.to_f64(je.fn(J, jdf.from_f64(x)))
        tol = TOL["df64"]
    else:
        tt = {"f32": torch.float32, "f64": torch.float64}[dtype]
        got = entry.fn(T, torch.as_tensor(x).to(tt)).numpy()
        want = np.asarray(je.fn(J, jnp.asarray(x, dtype=J_dtype(dtype))))
        tol = TOL[dtype]
    assert got.shape == (shape[0],)
    scale = _scale(ip, ix, dv, shape, x)
    _close(got, want, scale, tol, name)
    # and the product itself, in f64 (f32: the inputs' rounding, 1e-5)
    _close(got, _dense(ip, ix, dv, shape) @ x, scale, 1e-5 if dtype == "f32" else tol,
           f"{name} vs f64")
    assert (entry.transpose is None) == (je.transpose is None)
    if entry.transpose is not None:
        tt = {"f32": torch.float32, "f64": torch.float64}[dtype]
        got_t = entry.transpose(T, torch.as_tensor(u).to(tt)).numpy()
        want_t = np.asarray(je.transpose(J, jnp.asarray(u, dtype=J_dtype(dtype))))
        assert got_t.shape == (shape[1],)
        _close(got_t, want_t, _scale(ip, ix, dv, shape, u, True), tol, name + " T")


def J_dtype(dtype):
    return {"f32": jnp.float32, "f64": jnp.float64}[dtype]


def _dense(ip, ix, dv, shape):
    d = np.zeros(shape)
    np.add.at(d, (np.repeat(np.arange(shape[0]), np.diff(ip)), ix), dv)
    return d


def test_registry_names():
    from lilac_tpu.kernels import routed_spmv  # noqa: F401  (registers routed*)
    from lilac_tpu.kernels.registry import KERNELS as JK

    for name in GATHER + ("routed", "routed_df", "routed_hier", "routed_hier_df"):
        assert name in KERNELS and name in JK
        assert KERNELS[name].dfloat == JK[name].dfloat
        assert (KERNELS[name].transpose is None) == (JK[name].transpose is None)
    with pytest.raises(KeyError):
        get_kernel("pallas_ell")


def test_ops_spmv_matches_reference():
    ip, ix, dv, shape = _csr(9)
    rng = np.random.default_rng(10)
    x = rng.standard_normal(shape[1])
    u = rng.standard_normal(shape[0])
    X = rng.standard_normal((shape[1], 3))
    for name in ("xla_csr", "xla_coo", "xla_ell", "xla_bsr", "xla_sell"):
        J = _jax_container(name, ip, ix, dv, shape, "f64")
        T = _to_port(J)
        _close(tops.spmv(T, torch.as_tensor(x)).numpy(), np.asarray(jspmv(J, x)),
               _scale(ip, ix, dv, shape, x), 1e-12, name)
        if name in ("xla_csr", "xla_ell"):  # spmm is spmv per column
            Y = tops.spmm(T, torch.as_tensor(X)).numpy()
            np.testing.assert_allclose(Y, np.asarray(jspmm(J, jnp.asarray(X))),
                                       rtol=1e-12, atol=1e-12)
        if name in ("xla_csr", "xla_coo", "xla_ell"):
            _close(tops.spmv_t(T, torch.as_tensor(u)).numpy(),
                   np.asarray(jspmv_t(J, u)),
                   _scale(ip, ix, dv, shape, u, True), 1e-12, name + " T")
        else:
            with pytest.raises(TypeError):
                tops.spmv_t(T, torch.as_tensor(u))


# -- SpmvPlan ------------------------------------------------------------------


@pytest.mark.parametrize("dtype,kernel", [
    ("f32", "xla_ell"), ("f32", "xla_csr"), ("f32", "xla_sell"),
    ("f64", "xla_ell"), ("f64", "xla_csr"), ("f64", "xla_sell"),
    ("bf16", "xla_ell"), ("bf16", "xla_sell"),
    ("df64", "xla_ell_df"), ("df64", "xla_sell_df"),
])
def test_spmv_plan_matches_reference(dtype, kernel):
    ip, ix, dv, shape = _csr(11, kmax=6)
    x = np.random.default_rng(12).standard_normal(shape[1])
    u = np.random.default_rng(13).standard_normal(shape[0])
    jp = jplan.SpmvPlan(ip, ix, dv, shape, dtype=dtype, kernel=kernel)
    tp = tplan.SpmvPlan(ip, ix, dv, shape, dtype=dtype, kernel=kernel, device="cpu")
    assert tp.kernel == jp.kernel == kernel and tp.nnz == jp.nnz
    assert tp.row_stats == jp.row_stats
    got = tp.vec_out(tp.matvec(tp.vec_in(x)))
    want = jp.vec_out(jp.matvec(jp.vec_in(x)))
    scale = _scale(ip, ix, dv, shape, x)
    _close(got, want, scale, TOL[dtype], kernel)
    _close(got, _dense(ip, ix, dv, shape) @ x, scale,
           {"f32": 1e-5}.get(dtype, TOL[dtype]), kernel + " vs f64")
    if get_kernel(kernel).transpose is not None:
        got_t = tp.vec_out(tp.matvec_t(tp.vec_in(u)))
        want_t = jp.vec_out(jp.matvec_t(jp.vec_in(u)))
        _close(got_t, want_t, _scale(ip, ix, dv, shape, u, True), TOL[dtype],
               kernel + " T")
    else:
        with pytest.raises(ValueError, match="transposed_plan"):
            tp.matvec_t(tp.vec_in(u))


def _bare_plan(ip, shape, dtype, reuse="once", device="cpu"):
    """An SpmvPlan with its row statistics set and nothing staged, for the
    selector alone (a CUDA device needs no card for it)."""
    p = tplan.SpmvPlan.__new__(tplan.SpmvPlan)
    counts = np.diff(ip)
    p.shape, p.dtype, p.reuse, p.device = shape, dtype, reuse, torch.device(device)
    p.row_stats = dict(nrows=shape[0], nnz=int(counts.sum()), max_row=int(counts.max()),
                       mean_row=float(counts.mean()), std_row=float(counts.std()))
    return p


@pytest.mark.parametrize("case,want", [
    (("uniform", "f32", "once", "cpu"), "xla_ell"),
    (("spread", "f32", "once", "cpu"), "xla_sell"),
    (("uniform", "df64", "once", "cpu"), "xla_ell_df"),
    (("spread", "df64", "once", "cpu"), "xla_sell_df"),
    (("spread", "f64", "many", "cpu"), "xla_sell"),
    (("uniform", "f32", "many", "cuda"), "routed"),
    (("spread", "df64", "many", "cuda"), "routed_df"),
    (("wide", "f32", "many", "cuda"), "xla_ell"),
    (("uniform", "bf16", "many", "cuda"), "xla_ell"),
])
def test_select_kernel_branches(case, want):
    rows, dtype, reuse, device = case
    if rows == "wide":  # beyond one table: never routed by the reuse rule
        n = (1 << 18) + 1
        ip = np.arange(n + 1) * 3
        shape = (n, n)
    else:
        ip, ix, dv, shape = _csr(14, spread=rows == "spread", kmax=8)
        if rows == "uniform":
            ip = np.arange(shape[0] + 1) * 7
    assert _bare_plan(ip, shape, dtype, reuse, device)._select_kernel() == want
    if device == "cpu" and rows != "wide":
        # a plan built through the entry point selects the same
        ip, ix, dv, shape = _csr(14, spread=rows == "spread", kmax=8)
        if rows == "uniform":
            ip, ix, dv, shape = _uniform(shape)
        p = tplan.SpmvPlan(ip, ix, dv, shape, dtype=dtype, reuse=reuse, device="cpu")
        assert p.kernel == want


def _uniform(shape):
    rng = np.random.default_rng(15)
    n, ncol = shape
    cols = np.stack([np.sort(rng.choice(ncol, 7, replace=False)) for _ in range(n)])
    ip = np.arange(n + 1, dtype=np.int32) * 7
    return ip, cols.ravel().astype(np.int32), rng.standard_normal(n * 7), shape


@pytest.mark.parametrize("dtype", ["f64", "df64"])
def test_transposed_plan_matches_reference(dtype):
    ip, ix, dv, shape = _csr(16, n=120, ncol=200, dense_col=False, spread=False)
    u = np.random.default_rng(17).standard_normal(shape[0])
    kernel = "xla_sell_df" if dtype == "df64" else "xla_sell"
    jp = jplan.transposed_plan(ip, ix, dv, shape, dtype=dtype, kernel=kernel)
    tp = tplan.transposed_plan(ip, ix, dv, shape, dtype=dtype, kernel=kernel,
                               device="cpu")
    assert tp.shape == (shape[1], shape[0])
    got = tp.vec_out(tp.matvec(tp.vec_in(u)))
    _close(got, jp.vec_out(jp.matvec(jp.vec_in(u))),
           _scale(ip, ix, dv, shape, u, True), TOL[dtype], "transposed_plan")
    _close(got, _dense(ip, ix, dv, shape).T @ u, _scale(ip, ix, dv, shape, u, True),
           TOL[dtype], "transposed_plan vs f64")


@pytest.mark.parametrize("dtype", ["f32", "f64", "df64"])
def test_routed_plan_matches_gather(dtype, tmp_path, monkeypatch):
    """The `routed` registry entry (kernels K1 / K11 through their plain
    versions on the CPU) against the gather product, forwards and through
    the transpose slot; a second plan with the same cache_key loads the
    plan file."""
    monkeypatch.setenv("LILAC_DATA_DIR", str(tmp_path))
    ip, ix, dv, shape = _csr(18, n=2000, ncol=2048, kmax=12)
    rng = np.random.default_rng(19)
    x, u = rng.standard_normal(shape[1]), rng.standard_normal(shape[0])
    gk = "xla_csr" if dtype != "df64" else "xla_sell_df"
    g = tplan.SpmvPlan(ip, ix, dv, shape, dtype=dtype, kernel=gk, device="cpu")
    r = tplan.SpmvPlan(ip, ix, dv, shape, dtype=dtype, kernel="routed",
                       cache_key="t", device="cpu")
    assert r.kernel == ("routed_df" if dtype == "df64" else "routed")
    assert len(list(tmp_path.glob("plan_t_*.npz"))) == 1
    tol = TOL[dtype]
    scale = _scale(ip, ix, dv, shape, x)
    y = r.vec_out(r.matvec(r.vec_in(x)))
    _close(y, g.vec_out(g.matvec(g.vec_in(x))), scale, 2 * tol, "routed")
    yt = r.vec_out(r.matvec_t(r.vec_in(u)))
    _close(yt, _dense(ip, ix, dv, shape).T @ u, _scale(ip, ix, dv, shape, u, True),
           2 * tol, "routed T")
    again = tplan.SpmvPlan(ip, ix, dv, shape, dtype=dtype, kernel="routed",
                           cache_key="t", device="cpu")
    np.testing.assert_array_equal(again.vec_out(again.matvec(again.vec_in(x))), y)
    with pytest.raises(ValueError, match="bf16"):
        tplan.SpmvPlan(ip, ix, dv, shape, dtype="bf16", kernel="routed", device="cpu")


# -- bench CSV analysis ----------------------------------------------------------


def test_bench_tidy_and_geomean_match_reference(tmp_path, monkeypatch):
    path = tmp_path / "all.csv"
    rows = [
        tbench.BenchRow("gpu", "parboil-spmv", "xla_ell", "small", [0.5, 0.4, 0.6]),
        tbench.BenchRow("gpu", "parboil-spmv", "xla_sell", "small", [0.2, 0.25, 0.3]),
        tbench.BenchRow("gpu", "parboil-spmv", "xla_ell", "large", [4.0, 3.5]),
        tbench.BenchRow("gpu", "parboil-spmv", "xla_sell", "large", [1.0, 1.5]),
        tbench.BenchRow("tpu", "parboil-spmv", "xla_ell", "small", [0.3]),
        tbench.BenchRow("tpu", "parboil-spmv", "routed", "small", [0.1]),
        tbench.BenchRow("gpu", "sgemm", "cuda", "4096", [0.004]),
    ]
    tbench.append_rows(str(path), rows)
    with open(path, "a") as f:
        f.write("\n")  # a blank line is skipped
    recs = tbench.tidy(str(path))
    assert recs == jbench.tidy(str(path))
    assert len(recs) == 13
    got = tbench.geomean_speedups(recs, "xla_ell")
    assert got == jbench.geomean_speedups(recs, "xla_ell")
    assert got[("gpu", "parboil-spmv", "xla_sell")] == pytest.approx(
        np.sqrt((0.4 / 0.2) * (3.5 / 1.0)))
    assert set(got) == {("gpu", "parboil-spmv", "xla_sell"),
                        ("tpu", "parboil-spmv", "routed")}
    # bench pagerank: random_crs(size, seed=1) through pagerank.run, one run
    # a row entry, as in the JAX package
    from lilac_tpu_torch.workloads import pagerank as tpr

    calls = []

    class R:
        times_s = [0.25]

    monkeypatch.setattr(tpr, "run", lambda *a, **kw: calls.append((a, kw)) or R)
    row = tbench.run_bench("pagerank", "4", runs=2)
    assert row.times == [0.25, 0.25] and len(calls) == 2
    (ip, ix, dv, shape), kw = calls[0]
    assert kw == {"runs": 1} and shape == (64, 64)
    want = jrc.random_crs(4, seed=1)
    assert all(np.array_equal(a, b) for a, b in zip((ip, ix, dv), want[:3]))
