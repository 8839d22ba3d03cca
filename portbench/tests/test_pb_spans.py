"""The readers of the program's spans (yardstick/spans.py and the metrics
that use it) on hand-built traces: nested spans, a gap under a solver span,
a gap under an operator span, and a program with no spans (None)."""

import sys
import types

import numpy as np
import pytest

from portbench.harness import Readings, reader
from portbench.yardstick import spans
from portbench.yardstick.trace import Trace

MS = 1e-3
SPAN_METRICS = ("solver.glue_launches_per_step", "solver.glue_host_ms_per_step",
                "operator.glue_launches_per_matvec", "device.idle_in_solver_share")


def _trace(host, busy, launches=()):
    """A Trace from host ranges (name, start ms, end ms), the device's busy
    intervals (ms) and the start times (ms) of launch events."""
    host_ops = [(n, a * MS, b * MS) for n, a, b in host]
    host_ops += [("cudaLaunchKernel", t * MS, (t + 0.1) * MS) for t in launches]
    device = sorted(("kernel", a * MS, b * MS) for a, b in busy)
    return Trace(device_ops=device, host_ops=host_ops, marks={}, wall_s=1.0)


def _read(metric, trace):
    r = Readings()
    r.traces["steps"] = trace
    return reader(metric)(r)


# one outer step; a CG iteration with a matvec and a dot, then the residual
# with a matvec and a sub; each matvec holds its V and VT products and the
# kernel calls inside them
NESTED = [
    ("lilac.solver.step", 0, 100),
    ("lilac.solver.iter", 0, 40),
    ("lilac.operator.matvec", 5, 30),
    ("lilac.operator.V", 6, 14),
    ("lilac.kernels.route", 7, 12),
    ("lilac.operator.VT", 16, 28),
    ("lilac.kernels.mulred", 17, 27),
    ("lilac.solver.dot", 32, 38),
    ("lilac.solver.residual", 40, 90),
    ("lilac.operator.matvec", 41, 60),
    ("lilac.operator.V", 42, 58),
    ("lilac.kernels.route", 45, 55),
    ("lilac.solver.sub", 61, 70),
    ("aten::add", 62, 63),
    ("cudaMemcpyAsync", 34, 34.5),  # a copy is no launch
]
# kernel launches 8, 20, 50; operator glue 13, 15; solver glue 33, 35, 62,
# 95; after the step 110
LAUNCHES = (8, 13, 15, 20, 33, 35, 50, 62, 95, 110)
# idle gaps: [9, 11] in route, [14.5, 15.5] in matvec's own work, [33, 35]
# in dot, [63, 67] in sub, [100, 110] under no span; 19 ms in all, 6 ms of
# it under the solver's own spans
BUSY = [(0, 9), (1, 5), (11, 14.5), (15.5, 33), (35, 63), (67, 100), (110, 120)]


def test_nested_spans():
    t = _trace(NESTED, BUSY, LAUNCHES)
    assert _read("solver.glue_launches_per_step", t) == 4
    assert _read("operator.glue_launches_per_matvec", t) == 1.0
    assert _read("solver.glue_host_ms_per_step", t) == pytest.approx(100 - 25 - 19)
    assert _read("device.idle_in_solver_share", t) == pytest.approx(6 / 19)
    by = spans.idle_by_span(t)
    assert {k: round(v / MS, 6) for k, v in by.items()} == {
        "lilac.kernels.route": 2, "lilac.operator.matvec": 1, "lilac.solver.dot": 2,
        "lilac.solver.sub": 4, None: 10}


def test_the_glue_is_read_per_step_and_per_matvec():
    """Two steps, each a copy of the one above: the same readings."""
    second = [(n, a + 200, b + 200) for n, a, b in NESTED]
    t = _trace(NESTED + second, BUSY + [(a + 200, b + 200) for a, b in BUSY],
               LAUNCHES + tuple(x + 200 for x in LAUNCHES))
    assert _read("solver.glue_launches_per_step", t) == 4
    assert _read("operator.glue_launches_per_matvec", t) == 1.0
    assert _read("solver.glue_host_ms_per_step", t) == pytest.approx(56)


def test_a_gap_under_a_solver_span():
    host = [("lilac.solver.step", 0, 50), ("lilac.solver.iter", 0, 50),
            ("lilac.solver.dot", 20, 30), ("aten::sum", 24, 26)]
    t = _trace(host, [(0, 22), (28, 50)])
    assert _read("device.idle_in_solver_share", t) == 1.0


def test_a_gap_under_an_operator_span():
    host = [("lilac.solver.step", 0, 50), ("lilac.solver.iter", 0, 50),
            ("lilac.operator.matvec", 10, 40), ("lilac.operator.V", 12, 38),
            ("lilac.solver.dot", 41, 45)]
    t = _trace(host, [(0, 22), (28, 50)])
    assert _read("device.idle_in_solver_share", t) == 0.0
    # a busy device: no idle time to put down
    assert _read("device.idle_in_solver_share", _trace(host, [(0, 50)])) == 0.0


def test_no_spans_read_none():
    host = [("aten::add", 1, 2), ("aten::mul", 3, 4)]
    t = _trace(host, [(0, 1.5), (3, 5)], launches=(1, 3))
    for m in SPAN_METRICS:
        assert _read(m, t) is None
    assert all(reader(m)(Readings()) is None for m in SPAN_METRICS)
    # spans but no device (a CPU run): the device readings are not taken
    assert all(_read(m, _trace(NESTED, [], LAUNCHES)) is None for m in SPAN_METRICS)


def test_plan_read_s(monkeypatch):
    name = "lilac_tpu_torch.utils.profiling"
    read = reader("host_build.plan_read_s")
    monkeypatch.delitem(sys.modules, name, raising=False)
    assert read(Readings()) is None
    mod = types.ModuleType(name)
    monkeypatch.setitem(sys.modules, name, mod)
    assert read(Readings()) is None  # a program that keeps no set-up totals
    mod.BUILD = types.SimpleNamespace(total={"lilac.build.plan": 3.0,
                                             "lilac.build.plan.read": 1.25})
    assert read(Readings()) == 1.25
    mod.BUILD.total["lilac.build.plan.route"] = 40.0  # built, not read
    assert read(Readings()) is None


def test_helpers():
    iv = np.array([[0.0, 2.0], [1.0, 3.0], [5.0, 6.0]])
    assert spans.merged(iv).tolist() == [[0.0, 3.0], [5.0, 6.0]]
    t = np.array([-1.0, 0.0, 2.5, 4.0, 6.0, 7.0])
    assert spans.covered(t, iv).tolist() == [False, True, True, False, True, False]
    assert spans.seconds_within(np.array([[1.0, 5.5]]), iv) == pytest.approx(2.5)
    assert spans.merged(np.zeros((0, 2))).shape == (0, 2)
    assert not spans.covered(t, np.zeros((0, 2))).any()
