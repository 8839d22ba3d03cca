"""Observability: spans, phase timers, report cards, roofline accounting.

Counterpart of lilac_tpu/utils/profiling.py (the reference's per-section
timers and parboil's time categories):

* span()          a named host-only range at a layer boundary of the
                  program, recorded while a torch profiler records;
* chip_spec()     the card's published peaks, looked up by its name;
* PhaseTimers     named wall-clock sections, fenced by
                  torch.cuda.synchronize, printable as NPB's report card;
                  BUILD totals the set-up spans of the process;
* roofline()      achieved GB/s and FLOP/s against the card's peaks;
* spmv_traffic_bytes / routed_stage_work  a plan's bytes and stage work a
                  matvec;
* measure_stage_roofline / measure_plan_stage_time  K1 (and the
                  hierarchical passes K3-K6) timed on synthetic planes;
* trace()         torch.profiler around a region, written as a Chrome trace
                  with the spans on the kernels' timeline.

Host arithmetic and report strings are the JAX package's, character for
character, for the same inputs and the same spec.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict, Optional

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

# published peaks, f32 unless noted: the H100 SXM data sheet (HBM3
# 3.35 TB/s, 67 TFLOP/s f32, 989 TFLOP/s dense bf16 on the tensor cores),
# and the JAX package's nominal host entry
CHIP_SPECS = {
    "H100": dict(hbm_gbps=3350.0, f32_tflops=67.0, bf16_tflops=989.0),
    "cpu": dict(hbm_gbps=50.0, f32_tflops=1.0, bf16_tflops=1.0),
}


def chip_spec(device="cuda") -> dict:
    """The peaks of `device`: the CHIP_SPECS entry whose key its name holds
    (torch.cuda.get_device_name), "cpu" for the host. A CUDA card with no
    entry raises, naming the card: its ceilings are unknown, and the host's
    would make every share of them meaningless."""
    device = torch.device(device)
    if device.type != "cuda":
        return CHIP_SPECS["cpu"]
    name = torch.cuda.get_device_name(device)
    for k, v in CHIP_SPECS.items():
        if k != "cpu" and k.lower() in name.lower():
            return v
    raise ValueError(f"no published peaks for the card {name!r}: add it to "
                     "lilac_tpu_torch.utils.profiling.CHIP_SPECS")


def l2_bytes(device="cuda") -> int:
    """Bytes of the card's L2 cache (0 on the host): a working set under it
    can be served from L2, so its reads say nothing about HBM."""
    device = torch.device(device)
    if device.type != "cuda":
        return 0
    return int(torch.cuda.get_device_properties(device).L2_cache_size)


def synchronize(fence) -> None:
    """Wait for the work queued on `fence` (a device, or a tensor, a tuple
    or a DF pair whose first tensor names it). Nothing to wait for on the
    host."""
    while isinstance(fence, (tuple, list)):
        fence = fence[0]
    dev = fence.device if isinstance(fence, torch.Tensor) else torch.device(fence)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class PhaseTimers:
    """Named sections; `fence` (a device or a tensor) is synchronised before
    a section's clock stops, so the work it queued is inside the section."""

    def __init__(self):
        self.total: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self._open: Dict[str, float] = {}

    def start(self, name: str) -> None:
        self._open[name] = time.perf_counter()

    def stop(self, name: str, fence=None) -> float:
        if fence is not None:
            synchronize(fence)
        dt = time.perf_counter() - self._open.pop(name)
        self.total[name] = self.total.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1
        return dt

    @contextlib.contextmanager
    def section(self, name: str, fence_fn=None):
        """Wall-clock section. With the bare `with timers.section(x):` form
        nothing is fenced, so device work still in flight is not awaited:
        pass fence_fn=lambda: <device or tensor> to fence, or use
        start() / stop(fence=...) directly."""
        self.start(name)
        yield
        self.stop(name, fence=None if fence_fn is None else fence_fn())

    def report(self) -> str:
        """NPB print_results-style card (common/print_results.f)."""
        tmax = max(self.total.values(), default=0.0)
        lines = ["  SECTION            calls   time(s)    fraction"]
        for k in sorted(self.total, key=self.total.get, reverse=True):
            t = self.total[k]
            lines.append(
                f"  {k:18s} {self.counts[k]:6d} {t:10.4f} {t / tmax if tmax else 0:10.2%}"
            )
        return "\n".join(lines)


# the set-up spans of this process (plan read, upload, build; kernel
# libraries), by name: BUILD.report() prints them as NPB's card
BUILD = PhaseTimers()

# torch's function-scope range: a host event on the profiler's own clock,
# for which the profiler draws no device-side annotation (it draws one for
# the user-scope ranges of torch.profiler.record_function)
_Range = torch._C._profiler._RecordFunctionFast


class Span:
    """A named range at one of the program's layer boundaries,
    ``lilac.<layer>.<what>``, used as ``with SPAN:``. Made once a call site,
    at import: entering it constructs nothing.

    While a torch profiler records, the span opens a host-only range of its
    name on the profiler's clock, so it shares a clock with the device
    activity; its parent is the span that encloses it on the host thread.
    Otherwise entering it checks one flag and leaving it finds no open
    range. Spans of one object nest on one thread."""

    __slots__ = ("name", "_open")

    def __init__(self, name: str):
        self.name = name
        self._open = []

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            rf = _Range(self.name)
            rf.__enter__()
            self._open.append(rf)
        return self

    def __exit__(self, *exc):
        if self._open:
            self._open.pop().__exit__(None, None, None)
        return False


class BuildSpan(Span):
    """A set-up span: a Span that also totals its host-clock seconds in
    `timers` (BUILD), profiler or not. ``with SPAN(fence=device):`` waits
    for the device work queued inside it before its clock stops, so that
    work is inside the span. Set-up runs once a plan, so the clock costs
    nothing that matters."""

    __slots__ = ("timers", "_fence")

    def __init__(self, name: str, timers: PhaseTimers):
        super().__init__(name)
        self.timers = timers
        self._fence = None

    def __call__(self, fence=None) -> "BuildSpan":
        self._fence = fence
        return self

    def __enter__(self):
        self.timers.start(self.name)
        return super().__enter__()

    def __exit__(self, *exc):
        fence, self._fence = self._fence, None
        self.timers.stop(self.name, fence=fence)
        return super().__exit__(*exc)


def span(name: str, timers: Optional[PhaseTimers] = None) -> Span:
    """The span `name` ("lilac.<layer>.<what>"): a Span, or a BuildSpan
    totalled in `timers`."""
    return Span(name) if timers is None else BuildSpan(name, timers)


def tensor_bytes(obj) -> int:
    """Bytes of every tensor a container holds (dataclass fields, tuples,
    lists, nested)."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return sum(tensor_bytes(getattr(obj, f.name)) for f in dataclasses.fields(obj))
    if isinstance(obj, (tuple, list)):
        return sum(tensor_bytes(v) for v in obj)
    return 0


def spmv_traffic_bytes(plan) -> dict:
    """Device traffic of one matvec of a staged SpmvPlan.

    Every tensor of the staged container is streamed once a matvec (values,
    indices, bit-packed mask planes, ...), so the container is the traffic
    model's ground truth. Kernel families then add their intermediates, as
    the JAX package counts them:

      xla_* gather kernels: one gathered-x read per stored element;
      routed*: the slot-product planes (vals-shaped) are written and read
        back by the chunk reduce, and the un-permute is one more read and
        write of y.

    Returns component bytes and 'total'; feed total to roofline()."""
    a_bytes = tensor_bytes(plan.A)
    n, ncols = plan.shape
    vit = 8 if plan.dtype in ("f64", "df64") else 4
    x_bytes = ncols * vit
    y_bytes = n * vit
    extra = 0
    k = plan.kernel
    if k.startswith("xla"):
        extra = plan.nnz * vit
    elif k.startswith("routed") or k == "factored":
        vals = getattr(plan.A, "vals", None)
        vals_bytes = tensor_bytes(vals) if vals is not None else plan.nnz * vit
        extra = 2 * vals_bytes + 2 * y_bytes
    total = a_bytes + x_bytes + y_bytes + extra
    return dict(
        container=a_bytes, x=x_bytes, y=y_bytes, intermediates=extra,
        total=total,
    )


def routed_stage_work(plan) -> Optional[dict]:
    """Stage-application work of a single-table routed plan (or a factored
    operator of them), in stage-elements: one switch decision on one slot of
    one value plane. None where stage work is not the cost model
    (hierarchical plans run passes over device memory; gather kernels
    gather). A factored operator in `adj` mode (VT None) runs V's stages
    again in reverse for Vᵀ."""
    from lilac_tpu_torch.kernels.routed_spmv import RoutedMat

    def one(A):
        if isinstance(A, RoutedMat):
            B = A.masks.shape[0]
            npl = 2 if A.vals.dim() == 3 else 1
            return B * len(A.kinds) * A.m * npl
        return None

    A = plan.A
    if hasattr(A, "V") and hasattr(A, "VT"):  # factored operator
        parts = [one(A.V), one(A.V if A.VT is None else A.VT)]
    else:
        parts = [one(A)]
    if any(p is None for p in parts):
        return None
    return dict(stage_elems=int(sum(parts)))


def _planes(m: int, nplanes: int, dtype, device) -> tuple:
    rng = np.random.default_rng(0)
    return tuple(
        torch.as_tensor(rng.normal(size=(m // 128, 128)), device=device).to(dtype)
        for _ in range(nplanes))


def timed_chain(step, x, reps: int) -> float:
    """Seconds one step of a chain of `reps` steps from `x` takes (each step
    fed the last one's output), between two synchronisations of the device
    the output lives on, after one untimed chain."""
    out = x
    for _ in range(reps):
        out = step(out)
    synchronize(out)
    t0 = time.perf_counter()
    out = x
    for _ in range(reps):
        out = step(out)
    synchronize(out)
    return (time.perf_counter() - t0) / reps


def measure_stage_roofline(
    m: int = 1 << 18, S: int = 64, nplanes: int = 1, reps: int = 30, device="cuda"
) -> dict:
    """Measured routed-stage throughput (stage-elements/s) of K1
    (kernels/routed.py:routed_apply) on a synthetic S-stage xor network over
    one [m] table of f32 planes. Two stage mixes are timed: the
    mixed-distance network (the Beneš shape) and an all-distance-1 network
    (the cheapest stage the kernel runs); the ceiling is the faster."""
    from lilac_tpu_torch.kernels.routed import routed_apply

    R = m // 128
    nb = max(int(np.log2(m)) - 1, 1)
    kinds = tuple("xor" for _ in range(S))
    dist_sets = {
        "mixed": tuple(1 << (i % nb) for i in range(S)),
        "unit": tuple(1 for _ in range(S)),
    }
    rng = np.random.default_rng(0)
    P = (S + 7) // 8
    masks = torch.as_tensor(
        rng.integers(0, 256, size=(1, P, R, 128), dtype=np.uint8).view(np.int8),
        device=device)
    planes = _planes(m, nplanes, torch.float32, device)

    rates = {}
    for label, dists in dist_sets.items():
        def step(pp, dists=dists):
            return tuple(o[0] for o in routed_apply(pp, masks, kinds, dists))

        t = timed_chain(step, planes, reps)
        rates[label] = m * S * nplanes / t

    rate = max(rates.values())
    return dict(
        stage_elems_per_s=rate, m=m, S=S, nplanes=nplanes,
        ns_per_stage_elem=1e9 / rate if rate else float("inf"),
        rate_by_mix={k: float(v) for k, v in rates.items()},
    )


def measure_plan_stage_time(plan, reps: int = 30) -> Optional[float]:
    """Seconds a matvec spends in the plan's own routing stages, replayed on
    synthetic planes of its value words: a single table through K1 (its
    tile passes, routed_passes), a packed hierarchical plan group by group
    through hier_apply_batched (K3-K6). The real matvec does this stage
    work plus the value multiply, the reduce and the un-permute, so the
    replay's time over the matvec's is an envelope (<= 1). None for plans
    whose cost is not stage work (gather kernels, unpacked hierarchical
    plans, factored operators)."""
    from lilac_tpu_torch.kernels import routed as rd
    from lilac_tpu_torch.kernels.routed_spmv import RoutedMat, RoutedMatHierP

    A = plan.A
    if isinstance(A, RoutedMat):
        npl = 2 if A.vals.dim() == 3 else 1
        planes = _planes(A.m, npl, A.vals.dtype, A.vals.device)

        def step(pp):
            outs = rd.routed_apply(pp, A.masks, A.kinds, A.dists)
            return tuple(o[0] for o in outs)

        return timed_chain(step, planes, reps)
    if isinstance(A, RoutedMatHierP):
        v0 = A.groups[0].vals
        npl = 2 if v0.dim() == 4 else 1
        planes = _planes(A.m, npl, v0.dtype, v0.device)

        def step_h(pp):
            acc = None
            for grp in A.groups:
                outs = rd.hier_apply_batched(pp, grp.pass_meta, grp.pass_masks, A.bl)
                t = outs[0][0]  # net 0's plane keeps the data dependence
                acc = t if acc is None else acc + t
            return (acc,) + tuple(pp[1:])

        return timed_chain(step_h, planes, reps)
    return None


def roofline(bytes_moved: float, flops: float, time_s: float, device="cuda") -> dict:
    """Achieved against ceiling rates for one measured region."""
    spec = chip_spec(device)
    gbps = bytes_moved / time_s / 1e9 if time_s else 0.0
    gflops = flops / time_s / 1e9 if time_s else 0.0
    return dict(
        gbps=gbps,
        gflops=gflops,
        frac_hbm=gbps / spec["hbm_gbps"],
        frac_flops=gflops / (spec["f32_tflops"] * 1e3),
        bound="memory" if gbps / spec["hbm_gbps"] > gflops / (spec["f32_tflops"] * 1e3) else "compute",
    )


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler around a region, the host and (where there is one)
    the card: with trace('/tmp/trace'): run(). Writes
    <logdir>/trace.json, a Chrome trace, in which the program's spans
    (lilac.solver.*, lilac.operator.*, lilac.kernels.*, lilac.build.*) lie
    on the host's rows above the kernels they launched."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
