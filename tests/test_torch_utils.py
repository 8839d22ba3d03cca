"""lilac_tpu_torch.utils (profiling, checkpoint) against the JAX package's,
on the CPU.

* PhaseTimers reports and roofline() are host arithmetic:
  the same strings and dicts under the "cpu" spec (the JAX package's
  chip_spec on its CPU backend).
* routed_stage_work counts the same stage work on the same matrix.
* spmv_traffic_bytes: x, y and the intermediates are the JAX package's
  numbers. The containers differ in one way: the port's index tensors are
  int64 (torch indexes with int64), the JAX package's int32, so the port's
  container is the JAX package's with every int32 leaf counted at 8 bytes
  (the routed masks are int8 in both).
* Checkpoints are the JAX package's .npz layout: each package loads the
  other's. checkpointed_power_method resumes bit for bit and matches the JAX
  package's zeta history to 1e-12.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from lilac_tpu.generate.npb import CLASSES as JCLASSES
from lilac_tpu.generate.npb import make_cg_matrix as jmake
from lilac_tpu.ops import dfloat as jdf
from lilac_tpu.plan import SpmvPlan as JPlan
from lilac_tpu.utils import checkpoint as jck
from lilac_tpu.utils import profiling as jprof
from lilac_tpu_torch.generate.npb import CLASSES, make_cg_matrix
from lilac_tpu_torch.generate.random_crs import random_crs
from lilac_tpu_torch.ops import dfloat as tdf
from lilac_tpu_torch.plan import FactoredNPBPlan, SpmvPlan
from lilac_tpu_torch.utils import checkpoint as tck
from lilac_tpu_torch.utils import profiling as tprof

torch.set_num_threads(1)

CPU = "cpu"


def test_phase_timer_report_is_the_reference_card():
    t, j = tprof.PhaseTimers(), jprof.PhaseTimers()
    for timers in (t, j):
        timers.total.update({"plan": 1.25, "solve": 10.5, "read": 0.003})
        timers.counts.update({"plan": 1, "solve": 75, "read": 2})
    assert t.report() == j.report()
    t.start("x")
    dt = t.stop("x", fence=torch.zeros(2))
    assert dt >= 0 and t.counts["x"] == 1
    with t.section("y", fence_fn=lambda: CPU):
        pass
    assert t.counts["y"] == 1 and "y" in t.report()


def test_flop_ledger_and_roofline_under_the_cpu_spec():
    assert tprof.chip_spec(CPU) == jprof.chip_spec() == tprof.CHIP_SPECS["cpu"]
    for args in ((1e9, 2e9, 0.01), (5e7, 1e12, 0.3), (1.0, 0.0, 0.0)):
        assert tprof.roofline(*args, device=CPU) == jprof.roofline(*args)


def test_chip_spec_names_the_card(monkeypatch):
    """The H100's published peaks; an unknown card raises, naming it (the
    JAX package hands it the CPU's ceilings)."""
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA H100 80GB HBM3")
    assert tprof.chip_spec("cuda") == dict(hbm_gbps=3350.0, f32_tflops=67.0,
                                           bf16_tflops=989.0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA A100-SXM4-40GB")
    with pytest.raises(ValueError, match="A100"):
        tprof.chip_spec("cuda")
    assert tprof.l2_bytes(CPU) == 0


@pytest.fixture(scope="module")
def crs12():
    return random_crs(12, seed=0)


@pytest.mark.parametrize("dtype", ["f32", "df64"])
def test_routed_stage_work_matches(crs12, dtype):
    t = SpmvPlan(*crs12, dtype=dtype, kernel="routed", device=CPU)
    j = JPlan(*crs12, dtype=dtype, kernel="routed")
    wt, wj = tprof.routed_stage_work(t), jprof.routed_stage_work(j)
    assert wt == wj and wt["stage_elems"] > 0
    A = t.A
    assert wt["stage_elems"] == A.masks.shape[0] * len(A.kinds) * A.m * (
        2 if dtype == "df64" else 1)
    assert tprof.routed_stage_work(SpmvPlan(*crs12, kernel="xla_ell", device=CPU)) is None


def test_routed_stage_work_of_the_factored_operator(monkeypatch):
    """The factored operator counts V and Vᵀ; in adj mode Vᵀ is V's own
    network run in reverse, the same stage work again."""
    monkeypatch.setenv("LILAC_FACTORED_SEGMODE", "routed")
    for vt in ("plan", "adj"):
        monkeypatch.setenv("LILAC_FACTORED_VT", vt)
        plan = FactoredNPBPlan("S", dtype="df64", device=CPU)
        V = plan.A.V
        VT = V if plan.A.VT is None else plan.A.VT
        assert (plan.A.VT is None) == (vt == "adj")
        want = sum(M.masks.shape[0] * len(M.kinds) * M.m * 2 for M in (V, VT))
        assert tprof.routed_stage_work(plan) == {"stage_elems": want}


def _jax_bytes(container, index_bytes=4) -> int:
    """Bytes of a JAX container's leaves, int32 (index) leaves counted at
    index_bytes."""
    return sum(leaf.size * (index_bytes if leaf.dtype == np.int32
                            else np.dtype(leaf.dtype).itemsize)
               for leaf in jax.tree_util.tree_leaves(container))


@pytest.mark.parametrize("kernel", ["xla_ell", "xla_sell", "xla_csr", "routed"])
def test_spmv_traffic_bytes(crs12, kernel):
    t = SpmvPlan(*crs12, dtype="f32", kernel=kernel, device=CPU)
    j = JPlan(*crs12, dtype="f32", kernel=kernel)
    tb, jb = tprof.spmv_traffic_bytes(t), jprof.spmv_traffic_bytes(j)
    assert tb["total"] == sum(tb[k] for k in ("container", "x", "y", "intermediates"))
    assert tb["container"] == tprof.tensor_bytes(t.A) == _jax_bytes(j.A, index_bytes=8)
    for k in ("x", "y"):
        assert tb[k] == jb[k]
    if kernel == "routed":
        assert tb["intermediates"] == 2 * tprof.tensor_bytes(t.A.vals) + 2 * tb["y"]
        assert tprof.tensor_bytes(t.A.vals) == _jax_bytes(j.A.vals)
    assert tb["intermediates"] == jb["intermediates"]


def test_stage_probes_run_k1_and_the_hier_passes(monkeypatch, crs12):
    """On the CPU the probes run the kernels' plain versions: the numbers
    are no measure of anything, the control flow and the shapes are."""
    p = tprof.measure_stage_roofline(m=1024, S=5, reps=2, device=CPU)
    assert set(p["rate_by_mix"]) == {"mixed", "unit"} and p["stage_elems_per_s"] > 0
    assert (p["m"], p["S"], p["nplanes"]) == (1024, 5, 1)
    for dtype in ("f32", "df64"):
        plan = SpmvPlan(*crs12, dtype=dtype, kernel="routed", device=CPU)
        assert tprof.measure_plan_stage_time(plan, reps=2) > 0
    from lilac_tpu_torch.kernels import routed_spmv as trs

    monkeypatch.setattr(trs, "SINGLE_TABLE_MAX", 1 << 10)
    monkeypatch.setenv("LILAC_HIER_BL", "256")
    ip, ix, v, sh = random_crs(11, seed=2)
    hier = SpmvPlan(ip, ix, v, sh, dtype="f32", kernel="routed", device=CPU)
    assert hier.kernel == "routed_hier"
    assert tprof.measure_plan_stage_time(hier, reps=1) > 0
    assert tprof.measure_plan_stage_time(
        SpmvPlan(ip, ix, v, sh, kernel="xla_ell", device=CPU)) is None


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path / "tr")):
        torch.ones(4).sum()
    with open(tmp_path / "tr" / "trace.json") as f:
        assert "traceEvents" in json.load(f)


def test_checkpoints_load_across_packages(tmp_path):
    """A JAX-written DF pair and array load in the port, and the reverse."""
    x = np.linspace(-3.0, 7.0, 11)
    d = np.asarray([1.0 + 2.0**-40, np.pi, -np.e])
    meta = dict(iter=3, zetas=[1.0, 2.5])
    state_j = {"x": jax.numpy.asarray(x), "d": jdf.from_f64(d)}
    jck.save_state(str(tmp_path / "j.npz"), state_j, meta)
    like = {"x": torch.zeros(11), "d": tdf.from_f64(np.zeros(3), device=CPU)}
    back, m = tck.load_state(str(tmp_path / "j.npz"), like, device=CPU)
    assert m == meta
    np.testing.assert_array_equal(back["x"].numpy(), x)
    np.testing.assert_array_equal(tdf.to_f64(back["d"]), jdf.to_f64(state_j["d"]))
    state_t = {"x": torch.as_tensor(x), "d": tdf.from_f64(d, device=CPU)}
    tck.save_state(str(tmp_path / "t.npz"), state_t, meta)
    back_j, m = jck.load_state(str(tmp_path / "t.npz"), state_j)
    assert m == meta
    np.testing.assert_array_equal(np.asarray(back_j["x"]), x)
    np.testing.assert_array_equal(jdf.to_f64(back_j["d"]), tdf.to_f64(state_t["d"]))
    assert not os.path.exists(str(tmp_path / "t.npz.tmp.npz"))


def test_checkpointed_power_method_resumes_bit_for_bit(tmp_path):
    """Class S in f64: 5 steps, then resumed to 15, is one uninterrupted run
    bit for bit; the history is the JAX package's to 1e-12 and verifies."""
    cls = CLASSES["S"]
    ip, ix, v, _ = make_cg_matrix("S")
    plan = SpmvPlan(ip, ix, v, (cls.na, cls.na), dtype="f64", device=CPU)
    x0 = plan.vec_in(np.ones(cls.na))
    p = str(tmp_path / "cg.npz")
    z1, _, start = tck.checkpointed_power_method(plan, x0, cls.shift, 5, path=p, every=5)
    assert start == 0 and len(z1) == 5
    z2, x2, start = tck.checkpointed_power_method(plan, x0, cls.shift, 15, path=p, every=5)
    assert start == 5 and len(z2) == 15
    z3, x3, _ = tck.checkpointed_power_method(plan, x0, cls.shift, 15,
                                              path=str(tmp_path / "cg2.npz"), every=15)
    np.testing.assert_array_equal(z2.view(np.uint64), z3.view(np.uint64))
    assert torch.equal(x2, x3)
    assert abs(z2[-1] - cls.zeta_verify) / cls.zeta_verify < 1e-10

    jcls = JCLASSES["S"]
    jip, jix, jv, _ = jmake("S")
    jplan = JPlan(jip, jix, jv, (jcls.na, jcls.na), dtype="f64")
    zj, _, _ = jck.checkpointed_power_method(jplan, jplan.vec_in(np.ones(jcls.na)),
                                             jcls.shift, 15, path=str(tmp_path / "j.npz"),
                                             every=15)
    np.testing.assert_allclose(z2, zj, rtol=1e-12)
