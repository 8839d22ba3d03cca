"""The NPB CG slice of lilac_tpu_torch against the JAX package: generator
and plan arrays bit for bit, the factored product on the same containers,
and whole class S runs. Everything runs on the CPU (device="cpu"), where
the port's kernels take their plain versions."""

import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lilac_tpu import config as jcfg
from lilac_tpu.formats import convert as jconv
from lilac_tpu.generate import npb as jnpb
from lilac_tpu.kernels import factored as jfac
from lilac_tpu.ops import dfloat as jdf
from lilac_tpu.workloads import npb_cg as jrun
from lilac_tpu_torch import config as tcfg
from lilac_tpu_torch import convert_reference as cr
from lilac_tpu_torch.formats import convert as tconv
from lilac_tpu_torch.generate import npb as tnpb
from lilac_tpu_torch.kernels import factored as tfac
from lilac_tpu_torch.kernels import routed_spmv as trs
from lilac_tpu_torch.ops import dfloat as tdf
from lilac_tpu_torch.workloads import npb_cg as trun

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def data_dirs(tmp_path, monkeypatch):
    """Separate cache directories: the port under <tmp>/torch, the JAX
    package under <tmp>/jax (both read LILAC_DATA_DIR when they build)."""

    def use(which):
        d = tmp_path / which
        d.mkdir(exist_ok=True)
        monkeypatch.setenv("LILAC_DATA_DIR", str(d))
        return d

    return use


def test_generator_bit_identical(data_dirs):
    cls = tnpb.CLASSES["S"]
    assert {k: dataclasses.astuple(v) for k, v in tnpb.CLASSES.items()} == {
        k: dataclasses.astuple(v) for k, v in jnpb.CLASSES.items()}
    jt, tt = jnpb._generate_triples(jnpb.CLASSES["S"]), tnpb._generate_triples(cls)
    tp = tnpb._generate_triples_py(cls.na, cls.nonzer)
    for a, b, c in zip(jt, tt, tp):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    r1, r2 = jnpb.Randlc(), tnpb.Randlc()
    assert [r1.next() for _ in range(5)] == [r2.next() for _ in range(5)]
    np.testing.assert_array_equal(r1.stream_ints(9), r2.stream_ints(9))
    jm = jnpb.make_cg_matrix("S", cache_dir=str(data_dirs("jax")))
    tm = tnpb.make_cg_matrix("S", cache_dir=str(data_dirs("torch")))
    tm2 = tnpb.make_cg_matrix("S", cache_dir=str(data_dirs("torch")))  # cached
    for a, b, c in zip(jm[:3], tm[:3], tm2[:3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_format_converters_bit_identical():
    rng = np.random.default_rng(0)
    n, ncol, nnz = 120, 90, 900
    row, col = rng.integers(0, n, nnz), rng.integers(0, ncol, nnz)
    val = rng.standard_normal(nnz)
    for dup in (True, False):
        j = jconv.coo_to_csr_arrays(row, col, val, (n, ncol), sum_duplicates=dup)
        t = tconv.coo_to_csr_arrays(row, col, val, (n, ncol), sum_duplicates=dup)
        for a, b in zip(j, t):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    indptr, indices, data = t
    for vals in (data, tdf.split_f64_np(data)):
        J = jconv.csr_to_seg_bucket_ell(indptr, indices, vals, (n, ncol), seg_size=n)
        T = tconv.csr_to_seg_bucket_ell(indptr, indices, vals, (n, ncol),
                                        seg_size=n, device="cpu")
        assert tuple(J.parts) == T.parts and J.identity_perm == T.identity_perm
        assert J.shape == T.shape and len(J.data) == len(T.data)
        np.testing.assert_array_equal(np.asarray(J.inv_perm), T.inv_perm.numpy())
        for a, b in zip(J.data, T.data):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        for a, b in zip(J.indices, T.indices):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # two column segments (local indices) and a tail (segment -1, global)
    J = jconv.csr_to_seg_bucket_ell(indptr, indices, data, (n, ncol), seg_size=50)
    T = tconv.csr_to_seg_bucket_ell(indptr, indices, data, (n, ncol), seg_size=50,
                                    device="cpu")
    assert tuple(J.parts) == T.parts and {p[2] for p in T.parts} == {0, 1, -1}
    assert J.identity_perm == T.identity_perm is True
    np.testing.assert_array_equal(np.asarray(J.inv_perm), T.inv_perm.numpy())
    for a, b in zip(J.data + J.indices, T.data + T.indices):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _seg_to_torch(A):
    return cr.seg_bucket_ell_from_arrays(
        [np.asarray(v) for v in A.data], [np.asarray(i) for i in A.indices],
        np.asarray(A.inv_perm), A.shape, A.parts, A.seg_size, A.identity_perm,
        device="cpu")


def _routed_to_torch(M):
    return cr.routed_mat_from_arrays(
        np.asarray(M.masks), np.asarray(M.vals), M.kinds, M.dists, M.chunks,
        None if M.inv_perm is None else np.asarray(M.inv_perm),
        M.shape, M.m, M.colmajor, device="cpu")


@pytest.mark.parametrize("segmode", ["single", "routed"])
@pytest.mark.parametrize("dtype", ["f32", "df64"])
def test_factored_matches_reference(segmode, dtype, data_dirs, monkeypatch):
    """build_factored's arrays are bit-identical, and the factored product
    agrees on the JAX package's own containers handed over through
    convert_reference: 1e-13 * max|y| in df64 (the JAX CPU path sums by the
    op chain, the port's routed path by dot2), 1e-6 in f32."""
    monkeypatch.setenv("LILAC_FACTORED_SEGMODE", segmode)
    data_dirs("jax")
    J, jn = jfac.build_factored("S", dtype=dtype)
    data_dirs("torch")
    T, tn = tfac.build_factored("S", dtype=dtype, device="cpu")
    assert jn == tn
    np.testing.assert_array_equal(np.asarray(J.s), T.s.numpy())
    np.testing.assert_array_equal(np.asarray(J.d0), T.d0.numpy())
    conv = _routed_to_torch if segmode == "routed" else _seg_to_torch
    C = cr.factored_from_arrays(conv(J.V), conv(J.VT), np.asarray(J.s),
                                np.asarray(J.d0), device="cpu")
    for own, handed in ((T.V, C.V), (T.VT, C.VT)):
        if segmode == "routed":
            assert (own.kinds, own.dists, own.chunks) == (handed.kinds, handed.dists, handed.chunks)
            assert torch.equal(own.masks, handed.masks)
            assert torch.equal(own.vals, handed.vals)
            assert own.inv_perm is None and handed.inv_perm is None  # sigma relabels
        else:
            assert own.parts == handed.parts
            assert all(torch.equal(a, b) for a, b in zip(own.data, handed.data))
            assert all(torch.equal(a, b) for a, b in zip(own.indices, handed.indices))

    x = np.random.default_rng(1).standard_normal(T.s.shape[0])
    if dtype == "df64":
        yj = jdf.to_f64(jfac.factored_spmv_df(J, jdf.from_f64(x)))
        yt = tdf.to_f64(tfac.factored_spmv_df(C, tdf.from_f64(x, device="cpu")))
        tol = 1e-13
    else:
        yj = np.asarray(jfac.factored_spmv(J, jnp.asarray(x, jnp.float32)), np.float64)
        yt = tfac.factored_spmv(C, torch.as_tensor(x, dtype=torch.float32)).numpy()
        tol = 1e-6
    assert yt.shape == yj.shape == (1400,)
    assert np.abs(yt - yj).max() <= tol * np.abs(yj).max()


def test_factored_cache_and_sidecar(data_dirs, monkeypatch):
    """The routed build persists both plans and the meta sidecar under the
    reference's names; a second build loads them and matches exactly; a
    damaged plan file is rebuilt, not trusted."""
    d = data_dirs("torch")
    monkeypatch.setenv("LILAC_FACTORED_SEGMODE", "routed")
    c1, n1 = tfac.build_factored("S", dtype="df64", device="cpu")
    names = sorted(f.name for f in d.iterdir())
    assert set(names) == {"routed2_S_df64_V_m.npz", "routed2_S_df64_VT_m.npz",
                          "routed2_S_df64_meta_m.npz"}, names
    monkeypatch.setattr(tnpb, "_generate_triples",
                        lambda cls: pytest.fail("cache hit regenerated triples"))
    c2, n2 = tfac.build_factored("S", dtype="df64", device="cpu")
    assert n1 == n2 and torch.equal(c1.s, c2.s)
    assert torch.equal(c1.V.masks, c2.V.masks) and torch.equal(c1.VT.vals, c2.VT.vals)
    monkeypatch.undo()
    monkeypatch.setenv("LILAC_DATA_DIR", str(d))
    monkeypatch.setenv("LILAC_FACTORED_SEGMODE", "routed")
    (d / "routed2_S_df64_V_m.npz").write_bytes(b"not a zip file")
    c3, _ = tfac.build_factored("S", dtype="df64", device="cpu")
    assert torch.equal(c1.V.masks, c3.V.masks) and torch.equal(c1.V.vals, c3.V.vals)
    # the JAX package reads the port's plan cache as its own
    from lilac_tpu.kernels.routed_spmv import load_routed

    J = load_routed(str(d / "routed2_S_df64_VT_m.npz"))
    np.testing.assert_array_equal(np.asarray(J.vals), c1.VT.vals.numpy())


@pytest.fixture(scope="module")
def reference_zetas():
    """The JAX package's class S runs (its CPU default: the gather path)."""
    return {dt: jrun.run("S", dtype=dt, kernel="factored") for dt in ("f64", "df64")}


@pytest.mark.parametrize("segmode", ["routed", "single"])
@pytest.mark.parametrize("dtype", ["f64", "df64"])
def test_npb_class_s_verifies(segmode, dtype, reference_zetas, data_dirs, monkeypatch):
    """The whole slice: verified at NPB's 1e-10, and zeta beside the JAX
    run's: within 1e-12 relative in f64, and within 1e-8 in df64, which is
    all the JAX CPU run is good for there (its compiled df64 program loses
    digits on XLA:CPU; the JAX package's own test holds it to 1e-8)."""
    data_dirs("torch")
    monkeypatch.setenv("LILAC_FACTORED_SEGMODE", segmode)
    r = trun.run("S", dtype=dtype, device="cpu")
    ref = reference_zetas[dtype]
    assert r.verified and r.rel_err <= 1e-10, r.rel_err
    tol = {"f64": 1e-12, "df64": 1e-8}[dtype]
    assert abs(r.zeta - ref.zeta) <= tol * abs(ref.zeta)
    assert ref.rel_err < tol
    assert r.niter == 15 and r.nnz == ref.nnz and r.class_name == "S"
    assert r.kernel == {"routed": "factored_routed", "single": "factored_gather"}[
        segmode] + ("_df" if dtype == "df64" else "")
    assert np.isfinite(r.rnorm_last) and r.rnorm_last < 1e-12
    assert "SUCCESSFUL" in trun.print_report(r)


def test_npb_run_options(data_dirs, monkeypatch):
    """steps_per_dispatch keeps its meaning (outer steps between host
    read-backs) and does not change the result; auto picks the gather
    operator on the CPU; f32 runs but cannot verify."""
    data_dirs("torch")
    a = trun.run("S", dtype="f64", device="cpu", niter=4)
    b = trun.run("S", dtype="f64", device="cpu", niter=4, steps_per_dispatch=3)
    monkeypatch.setenv("LILAC_STEPS_PER_DISPATCH", "1")
    c = trun.run("S", dtype="f64", device="cpu", niter=4)
    assert a.kernel == "factored_gather" and a.niter == 4
    assert a.zeta == b.zeta == c.zeta and a.rnorm_last == b.rnorm_last
    r32 = trun.run("S", dtype="f32", device="cpu", niter=15)
    assert not r32.verified and r32.rel_err < 1e-5


@pytest.mark.parametrize("dtype,kernel", [
    ("f64", "xla_ell"), ("f64", "xla_sell"),
    ("df64", "xla_ell_df"), ("df64", "xla_sell_df")])
def test_npb_registry_kernels_match_reference(dtype, kernel, data_dirs):
    """npb_cg.run with a registry kernel assembles NPB's matrix into an
    SpmvPlan, as the reference does: the port's whole class S run verifies
    at NPB's 1e-10, and its zeta after 3 outer steps is the JAX package's
    3-step run with the same kernel, within 1e-12 relative in f64 and 1e-8
    in df64 (the bar test_npb_class_s_verifies states for the JAX CPU
    run)."""
    torch.set_num_threads(1)
    data_dirs("torch")
    r = trun.run("S", dtype=dtype, kernel=kernel, device="cpu")
    assert r.kernel == kernel and r.factored_vt is None
    assert r.verified and r.rel_err <= 1e-10, r.rel_err
    data_dirs("jax")
    ref = jrun.run("S", dtype=dtype, kernel=kernel, niter=3)
    assert ref.kernel == kernel and r.nnz == ref.nnz
    tol = {"f64": 1e-12, "df64": 1e-8}[dtype]
    assert abs(r.zeta_history[2] - ref.zeta) <= tol * abs(ref.zeta)


def test_unported_paths_raise(data_dirs, monkeypatch):
    data_dirs("torch")
    # a registry kernel that SpmvPlan does not wire raises the reference's
    # error (xla_segscan is reached through the factored scan mode only); a
    # name the registry lacks raises the registry's
    with pytest.raises(ValueError, match="not wired into SpmvPlan"):
        trun.run("S", kernel="xla_segscan", device="cpu")
    with pytest.raises(KeyError, match="xla_nonesuch"):
        trun.run("S", kernel="xla_nonesuch", device="cpu")
    monkeypatch.setenv("LILAC_FACTORED_SEGMODE", "scan")
    A, _ = tfac.build_factored("S", device="cpu")
    assert A.V.nseg == A.VT.nseg == 1 and A.V.shape == (1400, 1400)
    monkeypatch.setenv("LILAC_FACTORED_SEGMODE", "mixed")
    with pytest.raises(NotImplementedError, match="JagELLT"):
        tfac.build_factored("S", device="cpu")
    monkeypatch.setenv("LILAC_FACTORED_SEGMODE", "routed")
    monkeypatch.setenv("LILAC_FACTORED_VT", "adj")
    # the adjoint product is ported: adj raises for no class, holds V's plan
    # alone and writes no VT file
    assert tfac._resolve_modes(tcfg.cfg(), 1_500_000, "cpu") == ("routed", "adj")
    A, _ = tfac.build_factored("S", device="cpu")
    assert A.VT is None and isinstance(A.V, trs.RoutedMat)
    assert not [f for f in os.listdir(os.environ["LILAC_DATA_DIR"]) if "_VT" in f]
    monkeypatch.setenv("LILAC_FACTORED_VT", "bogus")
    with pytest.raises(ValueError, match="factored_vt"):
        tfac.build_factored("S", device="cpu")
    monkeypatch.setenv("LILAC_FACTORED_VT", "plan")
    monkeypatch.setenv("LILAC_FACTORED_SEGMODE", "bogus")
    with pytest.raises(ValueError):
        tfac.build_factored("S", device="cpu")


def test_config_is_a_subset_of_the_reference_catalogue(monkeypatch):
    ref = {k.attr: k for k in jcfg.KNOBS}
    for k in tcfg.KNOBS:
        assert k.attr in ref, k.attr  # no new knob
        if k.attr == "hier_bl":
            # same name, another default: the JAX package's 2^16 slots fit a
            # TPU's on-chip memory; the port derives its block from a thread
            # block's shared memory (None = derived, 2^13 on an H100)
            assert k.env == ref[k.attr].env and k.default is None
            assert ref[k.attr].default == 1 << 16
            continue
        assert (k.env, k.typ, k.default) == (ref[k.attr].env, ref[k.attr].typ,
                                             ref[k.attr].default)
    monkeypatch.delenv("LILAC_DATA_DIR", raising=False)
    monkeypatch.delenv("LILAC_CACHE", raising=False)
    assert tcfg.cfg().resolved_data_dir() == os.path.join(REPO, "data", "torch")
    monkeypatch.setenv("LILAC_CACHE", "/tmp/x")
    assert tcfg.cfg().resolved_data_dir() == "/tmp/x"
    monkeypatch.setenv("LILAC_DF_FUSED", "0")
    assert tcfg.cfg().df_fused is False and "LILAC_DF_FUSED" in tcfg.cfg().describe()


def test_bench_line_has_the_reference_keys(data_dirs):
    from lilac_tpu_torch import bench_npb

    data_dirs("torch")
    line = bench_npb.run_class("S", "f64", "factored", device="cpu")
    assert list(line) == [
        "metric", "value", "unit", "vs_baseline", "verified", "zeta_rel_err",
        "mops", "dtype", "kernel", "factored_vt", "nnz", "device", "class_wall_s"]
    assert line["factored_vt"] == "plan"  # the gather layout has no reverse
    assert line["metric"] == "npb_cg_classS_time_to_solution" and line["verified"]
    json.dumps(line)
    # the reference suite's MKL times, copied
    src = open(os.path.join(REPO, "bench.py")).read()
    for cls, t in bench_npb.BASELINE_S.items():
        assert f'"{cls}": {t}' in src.replace("2181.90", "2181.9")
    with pytest.raises(RuntimeError, match="GPU"):
        bench_npb.main()


def test_port_imports_without_jax():
    """Every module of the port and chip_smoke.py import with jax and the
    JAX package blocked, and chip_smoke.py fails when there is no GPU."""
    code = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["lilac_tpu"] = None
import lilac_tpu_torch
names = ["lilac_tpu_torch"] + [m.name for m in pkgutil.walk_packages(
    lilac_tpu_torch.__path__, "lilac_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
assert len(names) >= 20, names
bad = [m for m, v in sys.modules.items() if v is not None
       and (m in ("jax", "jaxlib", "lilac_tpu") or m.startswith(("jax.", "lilac_tpu.")))]
assert not bad, bad
print("IMPORTED", len(names))
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0 and "IMPORTED" in p.stdout, p.stderr[-2000:]
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and '"ok"' not in p.stdout
