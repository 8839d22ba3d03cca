"""On a card: every cell of BENCHMARK.json runs and is correct, and its
control (the program's float32 path) is not, at the cell's own size."""

import json
import os
import subprocess
import sys

import pytest

from pb_support import REPO

with open(os.path.join(REPO, "BENCHMARK.json")) as _f:
    CELLS = [w["name"] for w in json.load(_f)["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_cell_is_correct_on_the_card(cell, card):
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed", "2147483701",
         "--seconds", "5", "--trace", "0"], cwd=REPO, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_on_the_card(cell, card):
    from portbench import calibrate, harness, run

    run.pin_environment()
    rows = calibrate.readings(harness.load_cell(cell), [101, 102, 103], 5.0,
                               dtype=calibrate.CONTROL_DTYPE)
    assert not any(r["correct"] for r in rows)
