"""The port's bench CLI (lilac_tpu_torch.bench) against the JAX package's:
the reference's subcommands with its defaults, on the CPU (--device cpu);
the MatrixMarket writer byte for byte; bench_npb's ladder arithmetic.

The one default that differs on purpose: the autotune rows file is the
package's own (lilac_tpu_torch/autotune/rows_h100.jsonl, found from the
package, whatever the working directory), where the reference's is a path
relative to the working directory."""

import argparse
import json
import re

import numpy as np
import pytest
import torch

from lilac_tpu.bench import __main__ as jmain
from lilac_tpu.io import readers as jrd
from lilac_tpu_torch import autotune as tat
from lilac_tpu_torch import bench_npb
from lilac_tpu_torch.bench import __main__ as tmain
from lilac_tpu_torch.generate.graphs import powerlaw_graph
from lilac_tpu_torch.io import readers as trd

torch.set_num_threads(1)

CPU = "cpu"
SUBCOMMANDS = {
    "devices": [], "config": [], "marshall": [], "spmv-roofline": [],
    "graph-scale": [], "spgemm": [], "weak-scaling": [], "ingest": [],
    "autotune-collect": [], "autotune-train": [],
    "run": ["--bench", "npb", "--size", "S"], "analyze": ["x.csv"],
}


class _Parsed(Exception):
    pass


def _namespace(main, argv, monkeypatch) -> dict:
    """The namespace main() parses argv into, without running anything."""
    real = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        raise _Parsed(vars(real(self, args, namespace)))

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Parsed) as e:
        main(argv)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", real)
    return e.value.args[0]


@pytest.mark.parametrize("cmd", sorted(SUBCOMMANDS))
def test_defaults_match_the_reference(cmd, monkeypatch):
    argv = [cmd] + SUBCOMMANDS[cmd]
    got = _namespace(tmain.main, argv, monkeypatch)
    want = _namespace(jmain.main, argv, monkeypatch)
    if cmd == "run":  # the port's rows name the GPU platform
        assert (got.pop("platform"), want.pop("platform")) == ("gpu", "tpu")
    if cmd.startswith("autotune"):
        assert got.pop("rows") == tat.DEFAULT_ROWS_PATH
        assert want.pop("rows") == "lilac_tpu/autotune/rows.jsonl"
    if "device" in got:
        assert got.pop("device") == "cuda"
    assert got == want


def test_config_lists_the_autotune_knob(capsys):
    assert tmain.main(["config"]) == 0
    out = capsys.readouterr().out
    assert re.search(r"^LILAC_AUTOTUNE_MODEL +", out, re.M)
    assert "LILAC_COMPILE_CACHE" not in out


def test_spgemm_cli(capsys):
    """spgemm --sizes 4,6 --device cpu: the reference's line a size, ESC's
    structure the host's."""
    assert tmain.main(["spgemm", "--sizes", "4,6", "--device", CPU]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2
    for line, n in zip(lines, (64, 216)):
        assert re.fullmatch(
            rf"  n= +{n} nnzA= +\d+ nnzC= +\d+  host +[0-9.]+s  esc\(device\) +[0-9.]+s"
            r"  struct_match=True  masked-dense +[0-9.]+s", line), line


def test_weak_scaling_runs_on_cpu_ranks(capsys):
    """weak-scaling --devices 1,2 on Gloo CPU ranks: one line a count, each
    naming the host transport, with the "path validated" tail and never a
    percentage (tests/test_dist.py's weak harness test asks the same of the
    JAX package)."""
    assert tmain.main(["weak-scaling", "--device", CPU, "--per-dev-n", "1000",
                       "--devices", "1,2", "--reps", "2"]) == 0
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert len(lines) == 2
    for line, nd in zip(lines, (1, 2)):
        assert re.fullmatch(
            rf"  n_dev={nd} n= +\d+ nnz= +\d+ +[0-9.]+ ms +[0-9.]+ Mnnz/s/dev "
            r"transport=host \(path validated; rates not meaningful on this mesh\)", line), line
    assert "%" not in out and "weak-scaling efficiency" not in out


def test_devices_and_marshall(capsys):
    assert tmain.devices(CPU) == ["cpu"]
    out = capsys.readouterr().out.splitlines()
    assert out == ["device 0: cpu platform=cpu",
                   "chip spec: {'hbm_gbps': 50.0, 'f32_tflops': 1.0, 'bf16_tflops': 1.0}"]
    walls = tmain.marshall(6, CPU)
    assert set(walls) == {"xla_ell", "xla_sell", "xla_csr", "routed/f32", "routed/df64"}
    out = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in out] == [
        "  plan build (xla_ell)", "  plan build (xla_sell)", "  plan build (xla_csr)",
        "  plan build (routed/f32)", "  plan build (routed/df64)"]


def test_spmv_roofline_rows(capsys):
    """On the CPU: no L2, so no row is l2_resident; no stage probe; the
    traffic is spmv_traffic_bytes over the port's containers."""
    rows = tmain.spmv_roofline([6], ["auto", "routed"], CPU, reps=2)
    assert [r["kernel"] for r in rows] == ["xla_sell", "routed"]
    for r in rows:
        assert not r["l2_resident"] and r["frac_hbm"] is not None
        assert r["stage_share"] is None and r["b_nnz"] == r["traffic_bytes"] / r["nnz"]
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "device: cpu  HBM ceiling 50.0 GB/s  L2 0 bytes"
    assert all("of HBM roofline" in ln for ln in out[1:]) and len(out) == 3


def test_ingest_round_trip(tmp_path, monkeypatch):
    """ingest at n = 3000: the file is the JAX package's writer's byte for
    byte, the arrays read back are the graph's, and a second run reads the
    file it left."""
    monkeypatch.setenv("LILAC_DATA_DIR", str(tmp_path))
    res = tmain.ingest(3000, 13.0, "mtx", "auto", 8, CPU)
    g = powerlaw_graph(3000, avg_deg=13.0, seed=7)
    for got, want in zip(res["arrays"], g):
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    jrd.write_matrix_market(str(tmp_path / "j.mtx"), *g)
    assert open(res["path"], "rb").read() == (tmp_path / "j.mtx").read_bytes()
    assert res["kernel"] == "xla_sell" and res["write_s"] is not None
    again = tmain.ingest(3000, 13.0, "mtx", "auto", 8, CPU)
    assert again["write_s"] is None
    np.testing.assert_array_equal(again["x"], res["x"])


@pytest.mark.parametrize("pattern", [False, True])
def test_matrix_market_writer_bytes(tmp_path, pattern):
    """Values of every kind (signed zeros, infinities, NaN, subnormals,
    integers past 2^53, 17-digit fractions), an empty row, and more than one
    chunk of 2^20 lines in pattern mode."""
    rng = np.random.default_rng(11)
    n = 1100 if pattern else 300
    per_row = 1000 if pattern else 40
    counts = rng.integers(0, 2 * per_row, size=n)
    counts[5] = 0
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    indices = rng.integers(0, 5000, size=indptr[-1]).astype(np.int32)
    data = rng.normal(size=indptr[-1]) * 10.0 ** rng.integers(-30, 30, size=indptr[-1])
    data[:9] = [0.0, -0.0, np.inf, -np.inf, np.nan, 5e-324, 2.0**60 + 3, 1.0, -1 / 3]
    args = (indptr, indices, data, (n, 5000))
    trd.write_matrix_market(str(tmp_path / "t.mtx"), *args, pattern=pattern)
    jrd.write_matrix_market(str(tmp_path / "j.mtx"), *args, pattern=pattern)
    assert (tmp_path / "t.mtx").read_bytes() == (tmp_path / "j.mtx").read_bytes()
    if pattern:
        assert indptr[-1] > 1 << 20


def test_autotune_cli_collects_and_trains(tmp_path, monkeypatch, capsys):
    """autotune-collect then autotune-train on the CPU, three matrices of the
    corpus, into files of the test's own."""
    from lilac_tpu_torch.generate.random_crs import random_crs

    mats = [(f"rc{s}", random_crs(s, seed=s)) for s in (4, 5, 6)]
    monkeypatch.setattr(tat, "corpus_v2", lambda max_n=0, seeds=0: iter(mats))
    rows, model = str(tmp_path / "rows.jsonl"), str(tmp_path / "m.json")
    assert tmain.main(["autotune-collect", "--rows", rows, "--kernels", "xla_ell,xla_csr",
                       "--reps", "2", "--device", CPU]) == 0
    assert capsys.readouterr().out.splitlines()[-1] == f"collected 3 new rows -> {rows}"
    assert tmain.main(["autotune-train", "--rows", rows, "--out", model]) == 0
    meta = json.load(open(model))["meta"]
    assert meta["device"] == "cpu" and meta["corpus_rows"] == 3


@pytest.mark.parametrize("wall,first,remaining", [
    (10.0, True, 500.0), (200.0, True, 500.0), (5.0, False, 100.0),
    (90.0, False, 60.0), (30.0, False, 1e4)])
def test_ladder_prediction_is_the_reference_rule(wall, first, remaining, monkeypatch):
    """bench.py:308-318: slowness = this rung's wall over its warm wall (a
    first rung at most twice its warm wall), at least 1; the next rung needs
    1.25 times its scaled warm wall plus 15 s."""
    monkeypatch.setattr(bench_npb, "WARM_WALL_S", {"A": 12.0, "B": 25.0, "C": 55.0})
    warm = 12.0
    slow = max(1.0, (min(wall, 2 * warm) if first else wall) / warm)
    fits, pred = bench_npb.next_rung_fits("A", wall, "B", remaining, first)
    assert pred == 25.0 * slow
    assert fits == (remaining >= 1.25 * pred + 15.0)


def test_warm_walls_cover_the_ladder():
    assert set(bench_npb.LADDER) <= set(bench_npb.WARM_WALL_S)
    assert all(w > 0 for w in bench_npb.WARM_WALL_S.values())
