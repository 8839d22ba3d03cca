"""lilac_tpu_torch.autotune against the JAX package's, on the CPU.

features, train, heuristic_label, LinearSelector's JSON, the corpora and
build_model_v2 are host numpy: bit for bit. The port's own rules are held
here too: every row names its card, one rows file holds one card's rows,
the default paths are the package's, the shipped model serves on no CPU,
measure skips only a kernel whose container refuses the matrix, and
SpmvPlan asks an installed model in the reference's order.
"""

import json
import os

import numpy as np
import pytest
import torch

from lilac_tpu import autotune as jat
from lilac_tpu_torch import autotune as tat
from lilac_tpu_torch.plan import SpmvPlan
from tests.conftest import random_csr

torch.set_num_threads(1)

CPU = "cpu"


@pytest.fixture
def no_model(monkeypatch):
    """No model installed (env unset, caches empty) before and after."""
    monkeypatch.delenv(tat.MODEL_ENV, raising=False)
    for mod in (tat, jat):
        monkeypatch.setattr(mod, "_cached_model", None)
        monkeypatch.setattr(mod, "_cached_path", None)


def _rows(n=40, seed=7, device="NVIDIA H100 80GB HBM3"):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        nrows = int(rng.integers(100, 300_000))
        nnz = int(nrows * rng.uniform(2, 40))
        mean = nnz / nrows
        feat = tat.features(nrows, nnz, mean, mean * rng.uniform(0, 2))
        times = {k: float(rng.uniform(1, 2)) for k in ("xla_ell", "xla_sell", "routed")}
        rows.append(dict(name=f"r{i}", feat=[float(v) for v in feat], times=times,
                         nrows=nrows, ncols=nrows, nnz=nnz, device=device))
    return rows


def _write(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


@pytest.mark.parametrize("args", [(1, 1, 1.0, 0.0), (1000, 5000, 5.0, 2.0),
                                  (150_000, 2_000_000, 13.3, 40.0), (0, 0, 0.0, 0.0)])
def test_features_and_heuristic_bit_for_bit(args):
    np.testing.assert_array_equal(tat.features(*args), jat.features(*args))
    for ncols in (1000, 1 << 18, (1 << 18) + 1):
        for max_row in (None, 3.0, 200.0):
            assert (tat.heuristic_label(args[0], ncols, args[2], args[3], max_row)
                    == jat.heuristic_label(args[0], ncols, args[2], args[3], max_row))


def test_train_and_selector_json_bit_for_bit(tmp_path):
    rows = _rows()
    X = np.asarray([r["feat"] for r in rows])
    y = [min(r["times"], key=r["times"].get) for r in rows]
    t, j = tat.train(X, y), jat.train(X, y)
    assert t.classes == j.classes
    for name in ("mean", "scale", "W", "b"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    t.save(str(tmp_path / "t.json"))
    j.save(str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    back = tat.LinearSelector.load(str(tmp_path / "j.json"))
    assert [back.predict(x) for x in X] == [j.predict(x) for x in X]


def _same_csr(u, v):
    for x, y in zip(u[:3], v[:3]):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert tuple(u[3]) == tuple(v[3])


def test_corpus_v2_bit_for_bit():
    got = list(tat.corpus_v2(max_n=5000))
    want = list(jat.corpus_v2(max_n=5000))
    assert [n for n, _ in got] == [n for n, _ in want]
    assert len(got) >= 60
    for (_, u), (_, v) in zip(got, want):
        _same_csr(u, v)


def test_default_corpus_bit_for_bit():
    got, want = tat.default_corpus(max_n=20_000), jat.default_corpus(max_n=20_000)
    assert [n for n, _ in got] == [n for n, _ in want] and len(got) == 6
    for (_, u), (_, v) in zip(got, want):
        _same_csr(u, v)


def test_build_model_v2_writes_the_same_numbers(tmp_path):
    rows = _rows()
    path = str(tmp_path / "rows.jsonl")
    _write(path, rows)
    tat.build_model_v2(path, str(tmp_path / "t.json"), verbose=False)
    jat.build_model_v2(path, str(tmp_path / "j.json"), verbose=False)
    t = json.loads((tmp_path / "t.json").read_text())
    j = json.loads((tmp_path / "j.json").read_text())
    assert t.pop("meta").pop("device") == rows[0]["device"]
    j.pop("meta")
    assert t == j
    tm = json.loads((tmp_path / "t.json").read_text())["meta"]
    jm = json.loads((tmp_path / "j.json").read_text())["meta"]
    tm.pop("device")
    # the port's meta also records the corpus's extent (predict's range)
    assert tm.pop("corpus_max_nrows") == max(r["nrows"] for r in rows)
    assert tm.pop("corpus_max_nnz") == max(r["nnz"] for r in rows)
    assert tm == jm


def test_build_model_v2_refuses_mixed_devices(tmp_path):
    rows = _rows(8)
    rows[3]["device"] = "cpu"
    path = str(tmp_path / "rows.jsonl")
    _write(path, rows)
    with pytest.raises(ValueError, match="devices"):
        tat.build_model_v2(path, str(tmp_path / "m.json"), verbose=False)
    del rows[3]["device"]
    _write(path, rows)
    with pytest.raises(ValueError, match="devices"):
        tat.build_model_v2(path, str(tmp_path / "m.json"), verbose=False)


def test_ship_gate_blocks_a_weak_model(tmp_path, monkeypatch, no_model):
    """A model whose held-out accuracy does not beat both baselines is not
    installed; a separable one is (tests/test_autotune_bench.py's case)."""
    rows = _rows(40, device=CPU)
    for i, r in enumerate(rows):  # routed wins 80%, features are noise
        win = "routed" if i % 5 else "xla_ell"
        r["times"] = {"routed": 2.0, "xla_ell": 2.0}
        r["times"][win] = 1.0
    rows_path, model_path = str(tmp_path / "rows.jsonl"), str(tmp_path / "m.json")
    _write(rows_path, rows)
    tat.build_model_v2(rows_path, model_path, verbose=False)
    d = json.loads(open(model_path).read())
    d["meta"]["test_accuracy"] = d["meta"]["majority_accuracy"]
    d["meta"]["gated_ok"] = False
    with open(model_path, "w") as f:
        json.dump(d, f)
    monkeypatch.setenv(tat.MODEL_ENV, model_path)
    assert tat.installed_model(CPU) is None
    assert tat.predict(1000, 5000, 5.0, 1.0, device=CPU) is None
    for i, r in enumerate(rows):  # separable on feat[0]
        win = "routed" if i % 2 else "xla_ell"
        r["times"] = {"routed": 2.0, "xla_ell": 2.0}
        r["times"][win] = 1.0
        r["feat"][0] = 5.0 if win == "routed" else -5.0
    _write(rows_path, rows)
    tat.build_model_v2(rows_path, model_path, verbose=False)
    assert json.loads(open(model_path).read())["meta"]["gated_ok"]
    tat._cached_model = tat._cached_path = None
    assert tat.installed_model(CPU) is not None


def test_model_serves_only_inside_its_corpus(tmp_path, monkeypatch, no_model):
    """predict answers for a matrix with no more rows and entries than the
    largest of the model's rows, and None beyond (the heuristic serves)."""
    rows = _rows(40, device=CPU)
    for i, r in enumerate(rows):  # separable on feat[0]: xla_csr above 0
        win = "xla_csr" if i % 2 else "xla_ell"
        r["times"] = {"xla_csr": 2.0, "xla_ell": 2.0}
        r["times"][win] = 1.0
        r["feat"][0] = 5.0 if win == "xla_csr" else -5.0
    rows_path, model_path = str(tmp_path / "rows.jsonl"), str(tmp_path / "m.json")
    _write(rows_path, rows)
    tat.build_model_v2(rows_path, model_path, verbose=False)
    monkeypatch.setenv(tat.MODEL_ENV, model_path)
    meta = json.loads(open(model_path).read())["meta"]
    n, nnz = meta["corpus_max_nrows"], meta["corpus_max_nnz"]
    assert (n, nnz) == (max(r["nrows"] for r in rows), max(r["nnz"] for r in rows))
    assert tat.installed_model(CPU) is not None
    assert tat.predict(n, nnz, 5.0, 1.0, device=CPU) == "xla_csr"
    assert tat.predict(n + 1, nnz, 5.0, 1.0, device=CPU) is None
    assert tat.predict(n, nnz + 1, 5.0, 1.0, device=CPU) is None
    # SpmvPlan on a matrix inside the extent takes the model's label
    (ip, ix, v), sh = random_csr(np.random.default_rng(4), 64, 64, 0.1)
    assert SpmvPlan(ip, ix, v, sh, dtype="f32", device=CPU).kernel == "xla_csr"


def test_collect_rows_resumes_and_names_the_device(tmp_path, monkeypatch):
    rng = np.random.default_rng(5)
    mats = []
    for i in range(3):
        (ip, ix, v), sh = random_csr(rng, 40 + 10 * i, 40 + 10 * i, 0.1)
        mats.append((f"m{i}", (ip, ix, v, sh)))
    monkeypatch.setattr(tat, "corpus_v2", lambda max_n=0, seeds=0: iter(mats))

    def fake_measure(ip, ix, d, sh, kernels, dtype="f32", reps=1, device="cuda"):
        return {k: 1.0 + j + 0.001 * sh[0] for j, k in enumerate(kernels)}

    monkeypatch.setattr(tat, "measure", fake_measure)
    rows = str(tmp_path / "rows.jsonl")
    assert tat.collect_rows(rows, ("a", "b"), verbose=False, device=CPU) == 3
    assert tat.collect_rows(rows, ("a", "b"), verbose=False, device=CPU) == 0
    got = [json.loads(ln) for ln in open(rows)]
    assert [r["name"] for r in got] == ["m0", "m1", "m2"]
    assert all(r["device"] == "cpu" for r in got)
    # a file holding another card's rows is refused, not extended
    other = _rows(1)
    with open(rows, "a") as f:
        f.write(json.dumps(other[0]) + "\n")
    with pytest.raises(ValueError, match="device"):
        tat.collect_rows(rows, ("a", "b"), verbose=False, device=CPU)


def test_measure_times_kernels_and_skips_only_refusals(monkeypatch):
    (ip, ix, v), sh = random_csr(np.random.default_rng(3), 200, 200, 0.05)
    t = tat.measure(ip, ix, v, sh, ["xla_ell", "xla_csr", "routed"], reps=2, device=CPU)
    assert set(t) == {"xla_ell", "xla_csr", "routed"} and all(x > 0 for x in t.values())
    # bf16 serves the gather kernels only: the routed container refuses it
    t = tat.measure(ip, ix, v, sh, ["xla_ell", "routed"], dtype="bf16", reps=1, device=CPU)
    assert set(t) == {"xla_ell"}

    def broken(self, A, x):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(SpmvPlan, "matvec_with", broken)
    with pytest.raises(RuntimeError, match="launch"):
        tat.measure(ip, ix, v, sh, ["xla_ell"], reps=1, device=CPU)


def test_defaults_are_the_package_files_and_no_model_ships(no_model):
    """The defaults are the package's files. A model ships since the
    card's corpus was collected (tests/test_torch_formats_dense.py holds
    it): it names its card, so on the CPU no model serves."""
    here = os.path.dirname(os.path.abspath(tat.__file__))
    assert tat.DEFAULT_MODEL_PATH == os.path.join(here, "model.json")
    assert tat.DEFAULT_ROWS_PATH == os.path.join(here, "rows_h100.jsonl")
    with open(tat.DEFAULT_MODEL_PATH) as f:
        assert "H100" in json.load(f)["meta"]["device"]
    assert tat.installed_model(CPU) is None
    assert tat.predict(1000, 5000, 5.0, 1.0, device=CPU) is None


def test_plan_uses_an_installed_model(tmp_path, monkeypatch, no_model):
    """tests/test_autotune_bench.py's case: a model that says xla_csr picks
    xla_csr for an f32 plan; a routed label is ignored on the CPU; df64 and a
    reuse="many" plan keep their rules (the model is asked after them)."""
    (ip, ix, v), sh = random_csr(np.random.default_rng(4), 64, 64, 0.1)
    heur = SpmvPlan(ip, ix, v, sh, dtype="f32", device=CPU).kernel  # no model yet
    assert heur in ("xla_ell", "xla_sell")
    for label, want in (("xla_csr", "xla_csr"), ("routed", heur)):
        X = [tat.features(100, 1000, 10, 1.0)]
        p = tmp_path / f"{label}.json"
        tat.train(np.asarray(X * 4), [label] * 4).save(str(p))
        monkeypatch.setenv(tat.MODEL_ENV, str(p))
        tat._cached_model = tat._cached_path = None
        jat._cached_model = jat._cached_path = None
        assert SpmvPlan(ip, ix, v, sh, dtype="f32", device=CPU).kernel == want
        assert SpmvPlan(ip, ix, v, sh, dtype="f32", reuse="many", device=CPU).kernel == want
        assert SpmvPlan(ip, ix, v, sh, dtype="df64", device=CPU).kernel == heur + "_df"
    from lilac_tpu.plan import SpmvPlan as JPlan

    monkeypatch.setenv(tat.MODEL_ENV, str(tmp_path / "xla_csr.json"))
    tat._cached_model = tat._cached_path = None
    jat._cached_model = jat._cached_path = None
    assert JPlan(ip, ix, v, sh, dtype="f32").kernel == SpmvPlan(
        ip, ix, v, sh, dtype="f32", device=CPU).kernel == "xla_csr"
