"""The port's smaller reference counterparts against the JAX package:
todense() on COO, CSR, ELL and BSR (F3), dfloat.rsqrt, sgemm's kernel
names (F4), and the committed autotune rows and model of the H100.

todense scatter-adds in both packages: equal bit for bit where no entry is
duplicated, duplicates to 1e-15 of the sum of their magnitudes (two
orders of adding). rsqrt is div(1, sqrt(a)) in both: the tolerance
tests/test_torch_dfloat.py documents for sqrt, the value within 2^-46
relative (the Newton step's f32 division may differ by an ulp). sgemm's
products are held to the bound K 2^-24 (|A| |B|^T) + 2^-24 |C| of the f64
product, as tests/test_torch_parboil.py holds them.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lilac_tpu.formats import convert as jconv
from lilac_tpu.formats import sparse as jsp
from lilac_tpu.ops import dfloat as jdf
from lilac_tpu.workloads import sgemm as jsg
from lilac_tpu_torch import autotune as tat
from lilac_tpu_torch.formats import convert as tconv
from lilac_tpu_torch.formats import sparse as tsp
from lilac_tpu_torch.kernels import gemm as tgemm
from lilac_tpu_torch.ops import dfloat as tdf
from lilac_tpu_torch.plan import SpmvPlan
from lilac_tpu_torch.workloads import sgemm as tsg
from tests.conftest import random_csr

torch.set_num_threads(1)


def _dup_coo(seed=0, n=30, m=41, nnz=400):
    """COO triples with many repeated (row, col) pairs."""
    rng = np.random.default_rng(seed)
    row = rng.integers(0, n, nnz)
    col = rng.integers(0, m, nnz)
    row[:50], col[:50] = 3, 5  # one position 50 times
    return row, col, rng.standard_normal(nnz), (n, m)


def _close_dup(t, j, row, col, val, shape):
    mag = np.zeros(shape)
    np.add.at(mag, (row, col), np.abs(val))
    assert t.shape == j.shape == shape
    assert np.all(np.abs(t - j) <= 1e-15 * mag)


def test_coo_and_csr_todense_sum_duplicates():
    row, col, val, shape = _dup_coo()
    jc = jsp.COO(jnp.asarray(row), jnp.asarray(col), jnp.asarray(val), shape)
    tc = tsp.COO(torch.as_tensor(row), torch.as_tensor(col), torch.as_tensor(val), shape)
    _close_dup(tc.todense().numpy(), np.asarray(jc.todense()), row, col, val, shape)
    # a CSR holding the duplicates as separate entries (no summing)
    order = np.argsort(row, kind="stable")
    indptr = np.zeros(shape[0] + 1, np.int64)
    np.cumsum(np.bincount(row, minlength=shape[0]), out=indptr[1:])
    jr = jconv.csr_device(indptr, col[order], val[order], shape)
    tr = tconv.csr_device(indptr, col[order], val[order], shape, device="cpu")
    tr_bare = tsp.CSR(tr.data, tr.indices, tr.indptr, shape)  # row_ids built on demand
    for t in (tr, tr_bare):
        _close_dup(t.todense().numpy(), np.asarray(jr.todense()), row, col, val, shape)


def test_ell_todense_cuts_padding_rows():
    (ip, ix, v), shape = random_csr(np.random.default_rng(2), 37, 23, 0.2)
    j = jconv.ell_device(ip, ix, v, shape, row_pad=8)
    t = tconv.ell_device(ip, ix, v, shape, row_pad=8, device="cpu")
    assert t.nrows_pad == 40 > shape[0]
    np.testing.assert_array_equal(t.todense().numpy(), np.asarray(j.todense()))
    dense = np.zeros(shape)
    np.add.at(dense, (np.repeat(np.arange(shape[0]), np.diff(ip)), ix), v)
    np.testing.assert_array_equal(t.todense().numpy(), dense)


@pytest.mark.parametrize("shape,block", [((37, 45), (8, 16)), ((64, 64), (8, 8)),
                                         ((5, 130), (8, 128))])
def test_bsr_todense_trims_the_ragged_edge(shape, block):
    (ip, ix, v), _ = random_csr(np.random.default_rng(3), *shape, 0.1)
    j = jconv.bsr_device(ip, ix, v, shape, block_shape=block)
    t = tconv.bsr_device(ip, ix, v, shape, block_shape=block, device="cpu")
    got = t.todense().numpy()
    assert got.shape == shape
    np.testing.assert_array_equal(got, np.asarray(j.todense()))
    dense = np.zeros(shape)
    np.add.at(dense, (np.repeat(np.arange(shape[0]), np.diff(ip)), ix), v)
    np.testing.assert_array_equal(got, dense)


def test_rsqrt_matches_the_reference():
    rng = np.random.default_rng(3)
    a64 = np.abs(rng.standard_normal(777) * 10.0 ** rng.uniform(-6, 6, 777)) + 1e-30
    s = jdf.split_f64_np(a64)
    ja = jdf.DF(jnp.asarray(s[..., 0]), jnp.asarray(s[..., 1]))
    ta = tdf.from_f64(a64, device="cpu")
    got, want = tdf.to_f64(tdf.rsqrt(ta)), jdf.to_f64(jdf.rsqrt(ja))
    exact = 1.0 / np.sqrt(a64)
    assert got.shape == (777,)
    assert np.all(np.abs(got - want) <= 2.0 ** -46 * exact)
    assert np.all(np.abs(got - exact) <= 2.0 ** -44 * exact)


def _gemm_bound(A, BT):
    a64, b64 = A.astype(np.float64), BT.astype(np.float64)
    c = a64 @ b64.T
    u = 2.0 ** -24
    return c, A.shape[1] * u * (np.abs(a64) @ np.abs(b64).T) + u * np.abs(c)


def test_sgemm_takes_the_reference_kernel_names():
    """"pallas" (the reference's hand kernel, its default) runs K12, "xla"
    torch.matmul, as in the reference; the port's names stay."""
    rng = np.random.default_rng(9)
    A = rng.standard_normal((70, 33)).astype(np.float32)
    BT = rng.standard_normal((45, 33)).astype(np.float32)
    c64, bound = _gemm_bound(A, BT)
    plain = tgemm.matmul_nt_plain(torch.as_tensor(A), torch.as_tensor(BT)).numpy()
    for name, route in (("pallas", "cuda"), ("xla", "torch"), ("auto", "cuda"),
                        ("cuda", "cuda"), ("torch", "torch")):
        C, res = tsg.run_arrays(A, BT, kernel=name, device="cpu")
        assert res.kernel == route and (res.m, res.n, res.k) == (70, 45, 33)
        assert np.all(np.abs(C - c64) <= bound)
        if route == "cuda":
            np.testing.assert_array_equal(C, plain)  # K12's plain version on the CPU
    Cj, _ = jsg.run_arrays(A, BT, kernel="xla")
    Ct, _ = tsg.run_arrays(A, BT, kernel="xla", device="cpu")
    assert np.all(np.abs(Ct.astype(np.float64) - np.asarray(Cj)) <= 2 * bound)
    with pytest.raises(ValueError, match="unknown sgemm kernel"):
        tsg.run_arrays(A, BT, kernel="mxu", device="cpu")


# ---- the committed corpus rows and model of the H100 ----------------------


@pytest.fixture
def committed(monkeypatch):
    """The package's rows and model, no LILAC_AUTOTUNE_MODEL, caches empty."""
    monkeypatch.delenv(tat.MODEL_ENV, raising=False)
    monkeypatch.setattr(tat, "_cached_model", None)
    monkeypatch.setattr(tat, "_cached_path", None)
    rows = tat._read_rows(tat.DEFAULT_ROWS_PATH)
    with open(tat.DEFAULT_MODEL_PATH) as f:
        model = json.load(f)
    return rows, model


def test_committed_rows_name_one_card(committed):
    rows, model = committed
    meta = model["meta"]
    assert {r["device"] for r in rows} == {meta["device"]}
    assert "H100" in meta["device"] and meta["source"] == "rows_h100.jsonl"
    names = [r["name"] for r in rows]
    assert len(set(names)) == len(names) == meta["corpus_rows"]
    for r in rows:
        assert set(r["times"]) <= {"xla_ell", "xla_sell", "xla_csr", "routed"}
        assert "xla_csr" in r["times"] and all(t > 0 for t in r["times"].values())
        assert len(r["feat"]) == 5 and r["nrows"] == r["ncols"] <= 250_000


def test_committed_model_is_the_rows_trained_again(committed, tmp_path):
    rows, model = committed
    out = str(tmp_path / "m.json")
    tat.build_model_v2(tat.DEFAULT_ROWS_PATH, out, verbose=False)
    with open(out) as f:
        again = json.load(f)
    assert again["classes"] == model["classes"]
    for k in ("mean", "scale", "W", "b"):
        np.testing.assert_allclose(again[k], model[k], rtol=1e-12, atol=1e-12)
    assert again["meta"] == model["meta"]
    meta = model["meta"]
    for k in ("test_accuracy", "majority_accuracy", "heuristic_accuracy", "gated_ok"):
        assert k in meta
    assert meta["gated_ok"] == (
        meta["test_accuracy"] > max(meta["majority_accuracy"], meta["heuristic_accuracy"]))


def test_committed_model_serves_only_on_its_card(committed, monkeypatch):
    """The model serves where its meta names the card and its gate holds,
    and only inside its corpus; on the CPU the heuristic serves, so
    SpmvPlan's auto is unchanged here."""
    rows, model = committed
    meta = model["meta"]
    assert tat.installed_model("cpu") is None
    assert tat.predict(1000, 5000, 5.0, 1.0, device="cpu") is None
    assert meta["corpus_max_nrows"] == max(r["nrows"] for r in rows) == 250_000
    assert meta["corpus_max_nnz"] == max(r["nnz"] for r in rows)
    with monkeypatch.context() as m:  # as on the card the meta names
        m.setattr(tat, "device_name", lambda device="cuda": meta["device"])
        assert (tat.installed_model("cpu") is not None) == meta["gated_ok"]
        sel = tat.LinearSelector.load(tat.DEFAULT_MODEL_PATH)
        for r in rows:  # every row of the corpus lies inside its extent
            f = r["feat"]
            mean = float(np.exp(f[2]))
            assert tat.predict(r["nrows"], r["nnz"], mean, mean * f[3], device="cpu") \
                == sel.predict(tat.features(r["nrows"], r["nnz"], mean, mean * f[3]))
        # the 1M-node power-law graphs (13 entries a row) lie beyond it
        assert tat.predict(1_000_000, 13_000_000, 13.0, 40.0, device="cpu") is None
    tat._cached_model = tat._cached_path = None
    (ip, ix, v), sh = random_csr(np.random.default_rng(4), 64, 64, 0.1)
    counts = np.diff(ip)
    spread = counts.max() > 1.5 * max(counts.mean(), 1.0) + 4
    assert SpmvPlan(ip, ix, v, sh, dtype="f32", device="cpu").kernel == (
        "xla_sell" if spread else "xla_ell")
