"""The program's spans (lilac_tpu_torch.utils.profiling.span) on the CPU, at
NPB class S through the routed layout, so that the kernel-layer spans are
reached through the kernels' plain versions.

* One outer step under a CPU torch.profiler records each solver, operator
  and kernel span where it belongs, each nested in the layer above.
* No span is a user-scope range (is_user_annotation), the kind for which
  the profiler would draw a device-side annotation on a card.
* With no profiler running, no range is constructed, and the histories and
  the last x are bit for bit those of a profiled run.
* A second plan from the same data directory is read, and BUILD says so.
"""

import collections
import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lilac_tpu_torch.generate.npb import CLASSES
from lilac_tpu_torch.plan import FactoredNPBPlan
from lilac_tpu_torch.solvers.algebra import get_algebra
from lilac_tpu_torch.solvers.cg import npb_power_method
from lilac_tpu_torch.utils import profiling

torch.set_num_threads(1)

CLS = CLASSES["S"]
DTYPES = ("df64", "f64")


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("spans_data")


@pytest.fixture
def routed(monkeypatch, data_dir):
    monkeypatch.setenv("LILAC_DATA_DIR", str(data_dir))
    monkeypatch.setenv("LILAC_FACTORED_SEGMODE", "routed")


def _steps(dtype, n=1, around=contextlib.nullcontext):
    """n outer steps from ones, the steps alone inside `around()`: the
    zeta and rnorm histories and the last x."""
    plan = FactoredNPBPlan("S", dtype=dtype, device="cpu")
    alg = get_algebra(dtype, device="cpu")
    x0 = plan.vec_in(np.ones(CLS.na))
    with around():
        zetas, rnorms, x = npb_power_method(plan.matvec_with, alg, plan.A, x0,
                                            CLS.shift, n)
    return alg.to_f64(zetas), alg.to_f64(rnorms), plan.vec_out(x)


def _spans(prof):
    """The lilac. events of a profile as (name, start_ns, end_ns,
    is_user_annotation, parent name), the parent being the innermost
    lilac. event that encloses it. Read from the profiler's own events:
    the FunctionEvent tree takes minutes to build for a df64 step."""
    evs = sorted(
        ((e.name(), e.start_ns(), e.end_ns(), e.is_user_annotation())
         for e in prof.profiler.kineto_results.events()
         if e.name().startswith("lilac.")),
        key=lambda e: (e[1], -e[2]))
    out, stack = [], []
    for e in evs:
        while stack and stack[-1][2] < e[2]:
            stack.pop()
        out.append(e + (stack[-1][0] if stack else None,))
        stack.append(e)
    return out


@pytest.fixture(scope="module", params=DTYPES)
def traced_step(request, data_dir):
    """(dtype, spans, results) of one profiled outer step."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LILAC_DATA_DIR", str(data_dir))
        mp.setenv("LILAC_FACTORED_SEGMODE", "routed")
        prof = profile(activities=[ProfilerActivity.CPU])
        results = _steps(request.param, around=lambda: prof)
    return request.param, _spans(prof), results


def test_one_step_records_each_span_in_its_layer(traced_step):
    dtype, spans, _ = traced_step
    count = collections.Counter(e[0] for e in spans)
    assert count["lilac.solver.step"] == 1
    assert count["lilac.solver.iter"] == 25
    assert count["lilac.solver.residual"] == 1
    assert count["lilac.operator.matvec"] == 26
    assert count["lilac.operator.V"] == count["lilac.operator.VT"] == 26
    assert count["lilac.kernels.route"] >= 52  # V's and VT's networks
    assert (count["lilac.kernels.mulred"] > 0) == (dtype == "df64")
    for method in ("dot", "add", "sub", "smul", "sdiv", "ssqrt"):
        assert count["lilac.solver." + method] > 0
    parents = {
        "lilac.solver.step": {None},
        "lilac.solver.iter": {"lilac.solver.step"},
        "lilac.solver.residual": {"lilac.solver.step"},
        "lilac.operator.matvec": {"lilac.solver.iter", "lilac.solver.residual"},
        "lilac.operator.V": {"lilac.operator.matvec"},
        "lilac.operator.VT": {"lilac.operator.matvec"},
        "lilac.kernels.route": {"lilac.operator.V", "lilac.operator.VT"},
        "lilac.kernels.mulred": {"lilac.operator.V", "lilac.operator.VT"},
    }
    for name, _, _, _, parent in spans:
        if name in parents:
            assert parent in parents[name], (name, parent)
        else:  # the solver's vector algebra, in the step, beside matvecs
            assert parent in ("lilac.solver.step", "lilac.solver.iter",
                              "lilac.solver.residual"), (name, parent)


def test_no_span_draws_a_device_annotation(traced_step):
    _, spans, _ = traced_step
    assert spans
    assert not any(e[3] for e in spans)


@pytest.mark.parametrize("dtype", DTYPES)
def test_no_range_is_constructed_without_a_profiler(routed, monkeypatch, dtype):
    class Raises:
        def __init__(self, *a, **k):
            raise AssertionError("a profiler range was constructed")

    monkeypatch.setattr(profiling, "_Range", Raises)
    zetas, _, _ = _steps(dtype)
    assert np.isfinite(zetas).all()
    # the patch is where the spans take their range from
    with pytest.raises(AssertionError, match="range was constructed"):
        with profile(activities=[ProfilerActivity.CPU]):
            _steps(dtype)


def test_results_are_bit_identical_under_the_profiler(routed, traced_step):
    dtype, _, traced = traced_step
    plain = _steps(dtype)
    for a, b in zip(plain, traced):
        assert np.array_equal(a.view(np.int64), b.view(np.int64))


@pytest.mark.parametrize("dtype", DTYPES)
def test_a_second_plan_is_read_and_build_totals_it(routed, dtype):
    FactoredNPBPlan("S", dtype=dtype, device="cpu")  # built or read
    before = profiling.BUILD.counts.get("lilac.build.plan.read", 0)
    plans = profiling.BUILD.counts["lilac.build.plan"]
    routes = profiling.BUILD.counts.get("lilac.build.plan.route", 0)
    FactoredNPBPlan("S", dtype=dtype, device="cpu")
    assert profiling.BUILD.counts["lilac.build.plan.read"] > before
    assert profiling.BUILD.counts["lilac.build.plan"] == plans + 1
    assert profiling.BUILD.counts.get("lilac.build.plan.route", 0) == routes
    assert profiling.BUILD.total["lilac.build.plan.read"] >= 0
    assert "lilac.build.plan.read" in profiling.BUILD.report()


def test_build_span_fences_and_spans_nest():
    timers = profiling.PhaseTimers()
    outer = profiling.span("lilac.build.test", timers)
    inner = profiling.span("lilac.build.test.inner", timers)
    assert isinstance(outer, profiling.BuildSpan)
    assert type(profiling.span("lilac.solver.test")) is profiling.Span
    with outer(fence=torch.zeros(1)):
        with inner:
            pass
    with outer:
        pass
    assert timers.counts == {"lilac.build.test": 2, "lilac.build.test.inner": 1}
    assert timers.total["lilac.build.test"] >= timers.total["lilac.build.test.inner"]
    # a plain span nests in itself, each level its own range
    same = profiling.span("lilac.solver.test")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with same:
            with same:
                assert len(same._open) == 2
    assert [e[0] for e in _spans(prof)] == ["lilac.solver.test"] * 2
    assert same._open == []
