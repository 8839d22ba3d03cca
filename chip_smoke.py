#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          (from the repository root, no arguments)

Drives lilac_tpu_torch's main path, NPB CG in df64 through the routed
factored operator, at the full width of NPB class C (na = 150000, the
widest class the single-table path serves) and of NPB class D
(na = 1500000, through ONE hierarchical plan run forwards for V and in
reverse for V^T, factored_vt=adj, which `auto` resolves to there), and
proves on the card that

* the CUDA kernels build from csrc/ (nvcc, sm_90a),
* TwoSum / TwoProd inside the df64 kernel's translation unit are exact,
* the solvers' df64 dot (kernels/dfdot.py, two launches) is the eager
  df.dot bit for bit at NPB class C's and D's na, at odd sizes and on
  adversarial planes, and is timed against it,
* the solvers' other df64 arithmetic (kernels/dfops.py: DF64Alg's add,
  sub, smul, sdiv and ssqrt, one launch a call) is DF64Alg's eager op
  chains bit for bit at the same sizes, on random, adversarial and edge
  planes, scalar with vector and with scalar, and is timed against them;
  NPB CG class C (76 outer steps) and D (100), and one SparseBench 160
  solve, give bit for bit the histories and the last x of the chains,
* each kernel agrees with its plain PyTorch version (and the routing
  appliers with the numpy applier of the networks) at the shapes the main
  path gives it and at a small size; the routing kernels bit for bit, the
  single-table ones (K1, K11) also with forced small tiles at m = 2^16 so
  that every pass kind of their schedule runs, the inner pass (K3, K3u,
  K7) also on forced stage schedules at m = 2^16 (1 to 7 register runs a
  pass, every word format, NaN payloads and signed zeros), the window pass
  (K5, K5u) and its adjoint (K9) at every span of output slots a thread
  block takes, K2 on whole products (every chunk in one launch), and the
  exchange passes equal the gather on the index they compose (timed as
  their library yardstick),
* a general sparse matrix (unsorted rows, a column dense enough to need
  block-aligned shifts) multiplies right through the hierarchical plan
  (kernels K3-K6; one net of it through their un-batched forms K3u-K6u
  equals its packed group's row bit for bit), and its transpose through
  the same plan in reverse (kernels K7-K10);
  the same matrix through column-segmented routing (two segments of 2^18
  columns, K1 on each, bit for bit against its plain version and timed;
  K2 in df64) in f32 and df64 against the gather plan, and its plan file
  saved and loaded back,
* a whole reversed schedule is the transpose of the gather it encodes
  (index_add_ on the composed index, in f64) and <G x, u> = <x, G^T u>,
* NPB class S verifies in f32 / f64 / df64 through both operators, class C
  verifies (zeta rel. err <= 1e-10) in df64 through the single-table routed
  operator and class D through the hierarchical one, with every kernel of
  each path launched on that run; class C also runs a few outer steps in
  the other factored_vt mode (adj, which launches K11) and the two zeta
  histories agree to 1e-12 (class D's other mode, plan with two forward
  plans, runs in the partial run "d"); class D also runs 3 outer steps in
  the mixed layout (factored_segmode=mixed: V from the plan file the adj
  run wrote, loaded and not rebuilt, V^T as the jagged-diagonal JagELLT
  gather) with its zeta and rnorm histories held to the adj run's first 3,
  and classes S and W verify in it,
* cg_solve (CG to rtol = 1e-10) on class C's matrix, through the factored
  routed plan in df64 (K1, K2) and through SpmvPlan's xla_ell in f64,
  stops before maxit with ||b - A x|| / ||b|| <= 10 rtol (scipy, f64),
* the factored operator's scan layout (factored_segmode=scan, SegELLScan,
  plain torch gathers a column segment at a time) verifies classes S and W
  in df64 and holds class D's first 3 zeta values to the adj run's to
  1e-12 (10 segments and a tail, its bytes, build and step wall beside
  adj's), and the general matrix below multiplies right through SegELLScan
  and multi-segment SegBucketELL (3 segments) in f64 and df64,
* the Parboil paths: sgemm's product (kernel K12, matmul_nt: an exact
  three-piece bf16 split, then the tensor cores) within
  K*2^-24*(|A||B|^T) + 2^-24*|C| of the f64 product at ragged small shapes
  (K = 0 included) and at Parboil's width (n = 4096), on four input kinds,
  its split bit for bit against the plain version, then sgemm.run_arrays at
  n = 4096; and
  Parboil spmv at the scale of its large dataset (Dubcova3: 146 689 rows,
  about 3.6 M entries after mirroring) from a MatrixMarket file through
  read_matrix_market -> SpmvPlan -> 50 chained products, matched against a
  golden output with the gather kernel the selector picks and with the
  single-table routed plan (K1 in f32), and that plan's transpose product
  (K11 in f32) against the host's f64 A^T u,
* SparseBench: the 20 golden rows of the reference's validation table
  (sizes 10 and 20, CG and GMRES with ILU-D and block-Jacobi) reproduce,
  line-ILU matches its loop-level oracle; the timed BiCG protocol
  (maxit 100, rtol 1e-6, df64) at size 40 (n = 64 000) through one
  single-table routed plan with A^T p by K11 (adj) and by a second plan,
  and at size 160 (n = 4 096 000, 27 466 726 entries) through ONE
  hierarchical routed plan forwards (K3-K6, K2) and in reverse (K7-K10),
  validated (true residual within 5% of the recurrence's), its first norms
  held to an f64 host replica of BiCG and to the gather path's run; the
  kernels on the size-160 plan's own passes bit for bit,
* the graph workloads in f32 on power-law graphs (generate/graphs.py):
  PageRank (128 iterations) within 1e-3 (L1, relative) of an f64 scipy
  replica and BFS from 16 sources equal to bfs_oracle, at n = 200 000
  through one routing table (K1) and at graph-scale's n = 1 000 000
  through ONE f32 hierarchical plan (K3-K6 on one plane of 4-byte words,
  every pass of a group bit for bit and timed) and through the gather
  path; at n = 300 000 the unrelabeled plan's un-permute network (K3u-K6u)
  gives the relabeled run's x; the bench's pagerank row,
* PATHSAMPLE: pfold and tfold (10 000 sweeps at T = 0.05, f64 gather) on a
  landscape of 100 000 minima equal to f64 host replicas of their sweeps to
  1e-12, NGT's detailed balance, pfold against the dense committor, and the
  bench's pathsample row,
* the tooling (phase tools): ESC SpGEMM at the bench's sizes and at
  n = 262 144 with expand_csr's structure bit for bit, its values within
  the f32 bound of the f64 products and the same bits on two runs, and
  masked_dense; spmv-roofline's rows (K1, and K3-K5 on a hierarchical
  plan at n = 343 000) with no HBM share and no replayed stage floor above
  1.05 of its matvec; marshall, devices and config; ingest at n = 1 000 000
  read back bit for bit with PageRank's x equal to the in-memory run's; a
  budgeted autotune collection whose rows name the card, its model and the
  selection it makes; the package's committed rows and model (trained again
  from the rows to the same weights and meta, served on this card exactly
  when its meta names it and its ship gate holds) and the label it gives
  each f32 `auto` path of this script; a class A df64 solve restarted from
  its checkpoint bit for bit (K1, K2); bench_npb's fingerprint,
* distribution (phase dist, lilac_tpu_torch.parallel): dryrun_multichip on
  1 rank under NCCL and on 4 ranks sharing the card through the host
  transport (Gloo); NPB class B df64 through DistSpmvPlan verified on 4
  ranks and on 1; on 4 ranks the stencil's halo plans (HaloSpmvPlan f64,
  HaloRoutedPlan df64 with K1) and random_crs(64)'s routed plans
  (DistRoutedPlan f32 with K1, DistRoutedHierPlan df64 with K3u-K6u) held
  to the single-card gather plan in matvecs, CG and BiCG, every rank's
  kernels bit for bit against their plain versions on its first matvec;
  bench weak-scaling at 1, 2 and 4 ranks.

It prints one JSON line per phase, then the line {"kernels": [...]} with
each kernel's measured time beside its bound, and last
{"ok": true, "device": {...}}. Any failure raises: the exit code is then
non-zero and no result line is printed. There is no CPU fall-back: with no
GPU the script fails at once.

Depth, never width, may be cut to keep the script inside its time limit:
CHIP_SMOKE_C_STEPS / CHIP_SMOKE_D_STEPS set the outer steps of the class C
and class D runs (default: all). A cut run cannot claim NPB's verification
and is held instead to the native-f64 gather operator's zeta history on the
card, to 1e-10 relative. Arguments name phases to run alone, for finding a
fault ("hier" = the small hierarchical checks and the general matrix, "k11"
= the single-table adjoint at a small size, "tiles" = K1 and K11 with
forced small tiles at m = 2^16, "inner" = K3, K3u and K7 on forced stage
schedules at m = 2^16 and timed at the main paths' shapes, "window" = K5,
K5u and K9 at every span, bit for bit, "c" = K1, K2, K11 on the class C plan,
then the class C main path,
"d" = the class D plan, its kernels and its runs, "gemm" = K12 and sgemm,
"parboil" = Parboil spmv, "cg" = cg_solve on class C, "scan" = the scan
layout (class D against 3 steps of adj), "mixed" = the mixed layout
(classes S and W, then class D against 3 steps of adj), "seg" = the
general matrix through column-segmented routing, "sparsebench" = the SparseBench
phase, "graphs" = PageRank and BFS, "pathsample" = PATHSAMPLE, "tools" =
the tooling phase, "dist" = the distribution phase, "dfdot" = the df64
dot's two-launch kernel against df.dot and timed, "dfops" = the df64
algebra's kernels against the op chains and timed, "dfops_runs" = NPB C
and D and SparseBench 160 through them and through the chains; opt-in,
never in the whole run: "graph_profile" = torch.profiler over 1 and 10
PageRank iterations at n = 1 000 000, routed and gather, "sb_profile" = torch.profiler over
A p, A^T p and 3 BiCG iterations at size 160, routed and gather,
"inner_diag", "window_diag" = K5 and K5u timed at every span,
"window_bt_diag" = K9 timed at every span, "exchange_diag" = K4u and K6u
at every launch shape, L2 flushed and back to back, beside copy_ (also
run beside an older tree of the package), "gemm_diag" = how the tensor
cores round K12's f32 sums); such a run exits 2 without the last line.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# the card's published peaks (bytes/s, f32 and dense bf16 FLOP/s), set by
# _set_peaks from lilac_tpu_torch.utils.profiling.chip_spec(): the bounds
# below are stated against them, with the card's power limit printed beside
PEAK_BYTES_S = PEAK_F32_FLOPS = PEAK_BF16_FLOPS = None

DEVICE = "cuda"  # every tensor of this script lives on the card


def _set_peaks() -> None:
    """The card's peaks from the package's one table (an unknown card
    raises there)."""
    from lilac_tpu_torch.utils.profiling import chip_spec

    global PEAK_BYTES_S, PEAK_F32_FLOPS, PEAK_BF16_FLOPS
    spec = chip_spec(DEVICE)
    PEAK_BYTES_S = spec["hbm_gbps"] * 1e9
    PEAK_F32_FLOPS = spec["f32_tflops"] * 1e12
    PEAK_BF16_FLOPS = spec["bf16_tflops"] * 1e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over `reps` calls, by CUDA events.

    A long matrix product is queued first, so that the host enqueues the
    timed launches while the card is still busy with it: the events then
    bracket the kernels running back to back, not the host's pace."""
    fn()
    blocker = torch.ones((8192, 8192), device=DEVICE)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        torch.mm(blocker, blocker)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_cold_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() with the L2 cache flushed before each
    call (128 MB written, the H100's L2 holds 50 MB), by CUDA events around
    each call alone: for a kernel whose inputs fit in L2, which back-to-back
    calls would otherwise read from there. As in time_ms, a long matrix
    product is queued first, so that every call is enqueued before the card
    reaches it and the events bracket the kernel, not the host's pace (a
    wrapper's Python takes longer than the flush)."""
    fn()
    flush = torch.empty(32 << 20, dtype=torch.float32, device=DEVICE)
    blocker = torch.ones((8192, 8192), device=DEVICE)
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]
    torch.cuda.synchronize()
    for _ in range(3):
        torch.mm(blocker, blocker)
    for start, end in pairs:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in pairs) / reps


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device() -> dict:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(out, flush=True)
    info = {"phase": "device", "nvidia_smi": out,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(info)
    return info


def phase_build() -> dict:
    from lilac_tpu_torch.kernels import _cuda

    info = _cuda.build_all()
    for name in _cuda.SOURCES:
        _cuda.load(name)
    regs = {
        name: [ln.strip() for ln in text.splitlines()
               if "registers" in ln or "spill" in ln]
        for name, text in info["ptxas"].items()
    }
    warnings = {name: [ln.strip() for ln in text.splitlines() if "warning" in ln.lower()]
                for name, text in info["ptxas"].items()}
    line = {"phase": "build", "seconds": round(info["seconds"], 2),
            "built": info["built"], "ptxas": regs,
            "warnings": {k: v for k, v in warnings.items() if v}}
    emit(line)
    return line


def phase_eft() -> dict:
    """TwoSum / TwoProd as compiled into the df64 kernel's translation unit,
    held against numpy f64: s + e == a + b and p + e == a * b exactly."""
    from lilac_tpu_torch.kernels.dfmulred import eft_probe

    rng = np.random.default_rng(0)
    n = 1 << 16
    scale = lambda: np.exp(rng.uniform(-18, 18, n) * np.log(2))  # noqa: E731
    a = (rng.standard_normal(n) * scale()).astype(np.float32)
    b = (rng.standard_normal(n) * scale()).astype(np.float32)
    # adversarial: near-cancelling sums, operands one ulp apart, full
    # 24-bit mantissas (the split's worst case), powers of two, zeros
    one = np.float32(1.0)
    eps = np.float32(2.0 ** -23)
    adv_a = np.array(
        [1 + eps, 1 + eps, 4097.0, 16777215.0, 16777215.0, 0.1, 1e-10, 3.0,
         1.0, 0.0, -0.0, 1 - eps / 2, 8388609.0, 1.9999999],
        dtype=np.float32)
    adv_b = np.array(
        [-1.0, 1 - eps / 2, 4097.0, 16777215.0, -16777214.0, -0.1, 1e10,
         1.0 / 3.0, 2.0 ** -24, 5.0, 7.0, 1 + eps, 8388607.0, 1.9999999],
        dtype=np.float32)
    near = (a * (one + eps * rng.integers(-4, 5, n).astype(np.float32)))
    a = np.concatenate([a, adv_a, a])
    b = np.concatenate([b, adv_b, -near.astype(np.float32)])
    out = eft_probe(torch.as_tensor(a, device=DEVICE),
                    torch.as_tensor(b, device=DEVICE))
    torch.cuda.synchronize()
    s, e_sum, p, e_prod = out.cpu().numpy().astype(np.float64)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    # s and p are the correctly rounded f32 results (numpy's f32 add is
    # IEEE; the 48-bit product is exact in f64, so one rounding to f32)
    if not (np.array_equal(s, (a + b).astype(np.float64))
            and np.array_equal(p, (a64 * b64).astype(np.float32).astype(np.float64))):
        raise AssertionError("eft: s or p is not the rounded f32 result")
    sum_err = np.abs((s + e_sum) - (a64 + b64))
    prod_err = np.abs((p + e_prod) - a64 * b64)
    line = {
        "phase": "eft", "n": int(len(a)),
        "two_sum_max_err": float(sum_err.max()),
        "two_prod_max_err": float(prod_err.max()),
        "nonzero_e_sum": int(np.count_nonzero(e_sum)),
        "nonzero_e_prod": int(np.count_nonzero(e_prod)),
    }
    emit(line)
    if not (line["two_sum_max_err"] == 0.0 and line["two_prod_max_err"] == 0.0
            and line["nonzero_e_sum"] > n // 2 and line["nonzero_e_prod"] > n // 2):
        raise AssertionError(f"eft: transformations are not exact: {line}")
    return line


# NPB C and D, three odd sizes, and SparseBench 160's n (the first launch at
# depth 6: its level 5 holds more than the second launch takes)
DFDOT_SIZES = (150000, 1500000, 1, 4097, 1234567, 4096000)


def _dfdot_planes(n: int, seed: int, adversarial: bool):
    """Two df vectors of n terms on the card. Random: 12 decades, every
    other product cancelling its neighbour's to 1e-9. Adversarial: hi words
    drawn from phase_eft's operands (one ulp apart, full 24-bit mantissas,
    powers of two, signed zeros) and subnormals, lo words of either sign,
    zero or -0.0."""
    from lilac_tpu_torch.ops import dfloat as df

    rng = np.random.default_rng(seed)
    if not adversarial:
        a = rng.standard_normal(n) * 10.0 ** rng.uniform(-6, 6, n)
        b = rng.standard_normal(n) * 10.0 ** rng.uniform(-6, 6, n)
        a[1::2] = -a[0:n - 1:2] * (1.0 + 1e-9)
        b[1::2] = b[0:n - 1:2]
        return df.from_f64(a, DEVICE), df.from_f64(b, DEVICE)
    eps = 2.0 ** -23
    ops = np.array([1 + eps, 1 - eps / 2, 4097.0, 16777215.0, -16777214.0, 0.1,
                    -0.1, 1e-10, 1e10, 1.0 / 3.0, 2.0 ** -24, 0.0, -0.0,
                    8388609.0, 8388607.0, 1.9999999, 1e-40, -2e-39],
                   dtype=np.float32)

    def plane():
        hi = ops[rng.integers(0, len(ops), n)]
        lo = (hi * np.float32(2.0 ** -30) * rng.uniform(-1, 1, n).astype(np.float32))
        lo[rng.random(n) < 0.2] = np.float32(-0.0)
        return df.DF(torch.as_tensor(hi, device=DEVICE),
                     torch.as_tensor(lo.astype(np.float32), device=DEVICE))

    return plane(), plane()


def _device_kernels(fn) -> int:
    """Kernels the card ran for one call of fn, by the profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith(("Memcpy", "Memset")))


def _host_us(fn, reps: int) -> float:
    """Host microseconds a call, the card waited for at the end."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e6


def phase_dfdot() -> dict:
    """The df64 dot of the solvers (kernels/dfdot.py, csrc/dfdot.cu) held to
    the eager df.dot on the card bit for bit, and to dfdot_plain (its
    schedule in eager ops on the host, at the library's K), at NPB class C's
    and D's na, at three odd sizes, at SparseBench 160's n (the first launch
    at depth 6) and on adversarial planes; then timed at
    C and D, L2 flushed and back to back, against the eager df.dot, beside
    the bound (16 n bytes over the card's peak) and the kernels each ran.
    Returns the kernel's row of the `kernels` line (timed at class C; its
    launches are the main paths')."""
    from lilac_tpu_torch.kernels import dfdot as kd
    from lilac_tpu_torch.ops import dfloat as df

    sms = kd.device_sms(torch.cuda.current_device())
    checks = []
    for n in DFDOT_SIZES:
        depth = kd.kernel_depth(n, sms)
        for adversarial in (False, True):
            u, v = _dfdot_planes(n, n + adversarial, adversarial)
            got, want = kd.dfdot(u, v), df.dot(u, v)
            host = kd.dfdot_plain(df.DF(u.hi.cpu(), u.lo.cpu()),
                                  df.DF(v.hi.cpu(), v.lo.cpu()), depth)
            torch.cuda.synchronize()
            for other, what in ((want, "df.dot on the card"), (host, "dfdot_plain")):
                if not (_bits_equal(got.hi.cpu(), other.hi.cpu())
                        and _bits_equal(got.lo.cpu(), other.lo.cpu())):
                    raise AssertionError(
                        f"dfdot at n = {n} (adversarial {adversarial}) != {what}: "
                        f"{(got.hi.item(), got.lo.item())} != "
                        f"{(other.hi.item(), other.lo.item())}")
            checks.append({"n": n, "adversarial": adversarial,
                           "depth": depth, "hi": got.hi.item(),
                           "lo": got.lo.item()})
    timed = []
    for n in DFDOT_SIZES[:2]:
        u, v = _dfdot_planes(n, n, False)
        fused = lambda: kd.dfdot(u, v)  # noqa: E731
        eager = lambda: df.dot(u, v)  # noqa: E731
        depth = kd.kernel_depth(n, sms)
        timed.append({
            "n": n, "depth": depth, "threads": [kd.level_size(n, depth), 1024],
            "ms": time_cold_ms(fused, 50), "warm_ms": time_ms(fused, 200),
            "bound_ms": 16 * n / PEAK_BYTES_S * 1e3, "bound_by": "bytes",
            "eager_ms": time_cold_ms(eager, 5), "eager_warm_ms": time_ms(eager, 10),
            "kernels": _device_kernels(fused), "eager_kernels": _device_kernels(eager),
            "host_us": _host_us(fused, 200), "eager_host_us": _host_us(eager, 10)})
    emit({"phase": "dfdot", "checks": len(checks), "sms": sms, "timed": timed,
          "values": checks})
    c = timed[0]
    return {
        "name": "dfdot", "route": "cuda", "source": "lilac_tpu_torch/csrc/dfdot.cu",
        "replaces": "none: the JAX package leaves ops/dfloat.py:dot to XLA",
        "launches": 0, "ms": c["ms"], "plain_ms": c["eager_ms"],
        "bound_ms": c["bound_ms"], "bound_by": c["bound_by"], "library_ms": None,
        "library": "none: no single PyTorch call computes a df64 dot",
        "shape": {"n": c["n"], "depth": c["depth"], "dtype": "float32 (hi, lo)"},
        "bytes": 16 * c["n"], "timed": timed}


# the solvers' df64 algebra by kernels/dfops.py: each entry and the DF64Alg
# method whose chain it replaces, and the calls of a df64 NPB outer step
# (CG's 25 iterations, the residual, the zeta update)
DFOPS_ENTRIES = {"add": "add", "sub": "sub", "mul": "smul", "div": "sdiv",
                 "sqrt": "ssqrt"}
DFOPS_PER_NPB_STEP = {"add": 51, "sub": 26, "mul": 76, "div": 52, "sqrt": 2}


class _ChainOnly:
    """Inside: DF64Alg refuses the kernels of kernels/dfops.py and runs the
    eager op chains, as the package did before them (the dot stays dfdot's)."""

    def __enter__(self):
        from lilac_tpu_torch.kernels import dfops

        self._shape = dfops.result_shape
        dfops.result_shape = lambda *operands: None
        return self

    def __exit__(self, *exc):
        from lilac_tpu_torch.kernels import dfops

        dfops.result_shape = self._shape
        return False


def _same_df(got, want) -> bool:
    """The same shape and bits in both planes, NaN where want is NaN."""
    for g, w in zip(got, want):
        g, w = g.contiguous(), w.contiguous()
        if g.shape != w.shape or g.dtype != w.dtype:
            return False
        same = (g.view(torch.int32) == w.view(torch.int32)) | (torch.isnan(g) & torch.isnan(w))
        if not bool(same.all()):
            return False
    return True


def _dfops_operands(n: int, seed: int, kind: str):
    """Two df vectors of n terms on the card: `random` and `adversarial` as
    _dfdot_planes makes them; `edge`: adversarial planes with +-inf in some
    hi words and the second vector's hi words the first's negated (they
    cancel) at every third term."""
    from lilac_tpu_torch.ops import dfloat as df

    u, v = _dfdot_planes(n, seed, kind != "random")
    if kind == "edge":
        uh, vh = u.hi.clone(), v.hi.clone()
        uh[::97] = float("inf")
        vh[3::89] = float("-inf")
        vh[1::3] = -uh[1::3]
        u, v = df.DF(uh, u.lo), df.DF(vh, v.lo)
    return u, v


def _dfops_checks(n: int, kind: str, seed: int) -> int:
    """Each entry against DF64Alg's chain on the same operands, bit for bit:
    vector with vector (every entry, elementwise), a 0-dim scalar times the
    vector, strided planes, and at small sizes and on edge planes 0-dim
    with 0-dim over 24 scalars drawn from the planes. Returns the
    comparisons made."""
    from lilac_tpu_torch.kernels import dfops
    from lilac_tpu_torch.ops import dfloat as df
    from lilac_tpu_torch.solvers.algebra import DF64Alg

    alg = DF64Alg(DEVICE)
    u, v = _dfops_operands(n, seed, kind)
    s = df.DF(v.hi[n // 2].clone(), v.lo[n // 2].clone())
    wide = [torch.zeros(2 * n, dtype=torch.float32, device=DEVICE) for _ in range(2)]
    for w, t in zip(wide, u):
        w[::2] = t
    strided = df.DF(wide[0][::2], wide[1][::2])
    cases = [(e, (u,) if e == "sqrt" else (u, v)) for e in DFOPS_ENTRIES] + [
        ("mul", (s, v)), ("add", (strided, v)), ("sub", (v, strided)),
        ("sqrt", (strided,))]
    if n <= 4097 or kind == "edge":
        for i in range(min(n, 24)):
            a = df.DF(u.hi[i].clone(), u.lo[i].clone())
            b = df.DF(v.hi[-1 - i].clone(), v.lo[-1 - i].clone())
            cases += [(e, (a, b)) for e in ("add", "sub", "mul", "div")] + [("sqrt", (a,))]
    for entry, args in cases:
        got = getattr(dfops, entry)(*args)
        with _ChainOnly():
            want = getattr(alg, DFOPS_ENTRIES[entry])(*args)
        if not _same_df(got, want):
            shapes = [tuple(a.hi.shape) for a in args]
            raise AssertionError(f"dfops.{entry} at n = {n} ({kind}, operands {shapes}) "
                                 "!= DF64Alg's op chain")
    return len(cases)


def _dfops_zero_checks() -> int:
    """sdiv of +-0 over +-0 and over finite divisors (the chain's bits, the
    numerator's zero), ssqrt of +-0 (df.sqrt's bits)."""
    from lilac_tpu_torch.kernels import dfops
    from lilac_tpu_torch.ops import dfloat as df
    from lilac_tpu_torch.solvers.algebra import DF64Alg

    alg = DF64Alg(DEVICE)
    scalar = lambda v: df.full((), v, device=DEVICE)  # noqa: E731
    zeros = [scalar(0.0), df.neg(scalar(0.0))]
    made = 0
    for num in zeros:
        for den in zeros + [scalar(2.5), scalar(-3e-40), scalar(1e30)]:
            got = dfops.div(num, den)
            with _ChainOnly():
                want = alg.sdiv(num, den)
            if not (_same_df(got, want) and _bits_equal(got.hi, num.hi)
                    and _bits_equal(got.lo, num.hi)):
                raise AssertionError(f"dfops.div({num.hi.item()}, {den.hi.item()}) "
                                     f"= {(got.hi.item(), got.lo.item())}")
            made += 1
        if not _same_df(dfops.sqrt(num), df.sqrt(num)):
            raise AssertionError(f"dfops.sqrt({num.hi.item()}) != df.sqrt")
        made += 1
    return made


def phase_dfops() -> dict:
    """The solvers' df64 algebra at one launch a call (kernels/dfops.py,
    csrc/dfops.cu) held to DF64Alg's eager op chains on the card bit for
    bit (NaN where the chain gives NaN) at DFDOT_SIZES, on random,
    adversarial and edge planes (+-inf, cancelling hi words), 0-dim scalar
    with vector and with 0-dim, strided planes, and sdiv / ssqrt at zero;
    then timed at NPB class C's and D's na, L2 flushed and back to back,
    against the chain, beside the bound (the planes' bytes over the card's
    peak), the kernels each ran and the host's microseconds a call. Returns
    the kernel's row of the `kernels` line (its launches are the main
    paths')."""
    from lilac_tpu_torch.kernels import dfops
    from lilac_tpu_torch.ops import dfloat as df
    from lilac_tpu_torch.solvers.algebra import DF64Alg

    checks = _dfops_zero_checks()
    for n in DFDOT_SIZES:
        for k, kind in enumerate(("random", "adversarial", "edge")):
            checks += _dfops_checks(n, kind, 3 * n + k)
    alg = DF64Alg(DEVICE)
    timed = []
    for n in DFDOT_SIZES[:2]:
        u, v = _dfops_operands(n, n, "random")
        s = df.DF(v.hi[0].clone(), v.lo[0].clone())
        t = df.DF(u.hi[1].clone(), u.lo[1].clone())
        for entry, args, nbytes in (("add", (u, v), 24 * n), ("sub", (u, v), 24 * n),
                                    ("mul", (s, v), 16 * n), ("div", (s, t), 24),
                                    ("sqrt", (s,), 16)):
            if n != DFDOT_SIZES[0] and nbytes <= 24:
                continue  # a 0-dim call is timed once
            fused = functools.partial(getattr(dfops, entry), *args)
            chain_fn = getattr(alg, DFOPS_ENTRIES[entry])

            def eager(chain_fn=chain_fn, args=args):
                with _ChainOnly():
                    return chain_fn(*args)

            timed.append({
                "entry": entry, "n": n if nbytes > 24 else 1,
                "ms": time_cold_ms(fused, 50), "warm_ms": time_ms(fused, 200),
                "bound_ms": nbytes / PEAK_BYTES_S * 1e3, "bound_by": "bytes",
                "eager_ms": time_cold_ms(eager, 5), "eager_warm_ms": time_ms(eager, 20),
                "kernels": _device_kernels(fused), "eager_kernels": _device_kernels(eager),
                "host_us": _host_us(fused, 200), "eager_host_us": _host_us(eager, 20)})
            before = dfops.launches[entry]
            fused()
            if dfops.launches[entry] != before + 1:
                raise AssertionError(f"dfops.{entry} launched "
                                     f"{dfops.launches[entry] - before} times a call")
    emit({"phase": "dfops", "checks": checks, "timed": timed})
    by = {(r["entry"], r["n"]): r for r in timed}
    c, d = by[("add", DFDOT_SIZES[0])], by[("add", DFDOT_SIZES[1])]
    return {
        "name": "dfops", "route": "cuda", "source": "lilac_tpu_torch/csrc/dfops.cu",
        "replaces": "none: the JAX package leaves ops/dfloat.py's chains to XLA",
        "launches": 0, "ms": c["ms"], "plain_ms": c["eager_ms"],
        "bound_ms": c["bound_ms"], "bound_by": c["bound_by"], "library_ms": None,
        "library": "none: no single PyTorch call computes a df64 add",
        "shape": {"entry": "add", "n": c["n"], "dtype": "float32 (hi, lo)"},
        "ms_class_d": d["ms"], "bound_ms_class_d": d["bound_ms"],
        "bytes": 24 * c["n"], "timed": timed}


def _reset_dfops_counts() -> None:
    from lilac_tpu_torch.kernels import dfops

    for k in dfops.launches:
        dfops.launches[k] = 0


def _check_dfops(kernels: dict, steps: int, what: str, main: bool = True) -> int:
    """dfops's launches in `steps` df64 NPB outer steps just run, held to
    DFOPS_PER_NPB_STEP entry by entry; into the `kernels` line's dfops row
    under `launches_<what>`, and into its `launches` where the run was a
    main path's."""
    from lilac_tpu_torch.kernels import dfops

    want = {k: steps * v for k, v in DFOPS_PER_NPB_STEP.items()}
    if dfops.launches != want:
        raise AssertionError(f"dfops launched {dfops.launches} in {steps} outer steps "
                             f"of {what} ({want} expected)")
    got = sum(dfops.launches.values())
    row = kernels.setdefault("dfops", {"name": "dfops", "launches": 0})
    row[f"launches_{what}"] = got
    row["launches_per_npb_step"] = got // steps
    if main:
        row["launches"] += got
    return got


def _npb_chain_vs_fused(kernels: dict, plan, class_name: str, steps: int) -> dict:
    """`steps` outer steps of NPB CG in df64 from x0 = ones on `plan`,
    through the kernels and through the eager chains (the dot dfdot's in
    both): zeta, rnorm and the last x bit for bit the same; the step walls
    beside each other."""
    from lilac_tpu_torch.generate.npb import CLASSES
    from lilac_tpu_torch.solvers.algebra import DF64Alg
    from lilac_tpu_torch.solvers.cg import npb_power_method

    cls = CLASSES[class_name]
    alg = DF64Alg(DEVICE)
    x0 = plan.vec_in(np.ones(cls.na, dtype=np.float64))

    def run(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = npb_power_method(plan.matvec_with, alg, plan.A, x0, cls.shift, n)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    run(1)  # every kernel of the path loaded
    _reset_dfops_counts()
    (zf, rf, xf), fused_s = run(steps)
    launches = _check_dfops(kernels, steps, f"runs_class_{class_name.lower()}_{steps}_steps",
                            main=False)
    with _ChainOnly():
        (zc, rc, xc), chain_s = run(steps)
    for got, want, what in ((zf, zc, "zeta"), (rf, rc, "rnorm"), (xf, xc, "x")):
        if not (_bits_equal(got.hi, want.hi) and _bits_equal(got.lo, want.lo)):
            raise AssertionError(f"class {class_name}, {steps} steps: {what} through "
                                 "dfops != through the op chains")
    zeta = float(zf.hi[-1].double() + zf.lo[-1].double())
    return {"class": class_name, "steps": steps, "bit_identical": ["zeta", "rnorm", "x"],
            "zeta": zeta, "zeta_rel_err": abs(zeta - cls.zeta_verify) / cls.zeta_verify,
            "fused_step_s": fused_s / steps, "chain_step_s": chain_s / steps,
            "dfops_launches": launches}


def _sb_chain_vs_fused(kernels: dict, size: int = 160) -> dict:
    """One timed-protocol BiCG solve of SparseBench `size` (routed, df64,
    b = 1) through the kernels and through the eager chains: its, hist and
    x bit for bit the same, the kernels' launches those of the solve
    (_sb_dfops), into the dfops row under `launches_runs_sb<size>`."""
    from lilac_tpu_torch.kernels import dfops
    from lilac_tpu_torch.workloads.sparsebench import BenchSolver

    sol = BenchSolver(size, maxit=100, rtol=1e-6, dtype="df64", seed=0, kernel="routed",
                      sigma_relabel=True, device=DEVICE)
    b = sol.plan.vec_in(np.ones(sol.n))
    sol.solve(b)  # every kernel of the path loaded
    _reset_dfops_counts()
    t0 = time.perf_counter()
    xf, its_f, hist_f, _ = sol.solve(b)
    fused_s = time.perf_counter() - t0
    counts = dict(dfops.launches)
    with _ChainOnly():
        t0 = time.perf_counter()
        xc, its_c, hist_c, _ = sol.solve(b)
        chain_s = time.perf_counter() - t0
    if counts != _sb_dfops(its_f):
        raise AssertionError(f"SparseBench {size}: dfops launched {counts} in one solve "
                             f"of its {its_f} ({_sb_dfops(its_f)} expected)")
    row = kernels.setdefault("dfops", {"name": "dfops", "launches": 0})
    row[f"launches_runs_sb{size}"] = sum(counts.values())
    if its_f != its_c or not _bits_equal(hist_f, hist_c) or not (
            _bits_equal(xf.hi, xc.hi) and _bits_equal(xf.lo, xc.lo)):
        raise AssertionError(f"SparseBench {size}: its / hist / x through dfops != "
                             f"through the op chains (its {its_f} / {its_c})")
    return {"size": size, "its": its_f, "bit_identical": ["its", "hist", "x"],
            "fused_solve_s": fused_s, "chain_solve_s": chain_s, "dfops_launches": counts}


def phase_dfops_runs(kernels: dict, plan_d=None) -> dict:
    """NPB CG class C for 76 outer steps and class D for 100 in df64, and one
    SparseBench 160 solve, each through dfops and through the op chains,
    bit for bit (class D's plan built where not given)."""
    runs = [_npb_chain_vs_fused(kernels, build_plan_c(), "C", 76)]
    torch.cuda.empty_cache()
    runs.append(_npb_chain_vs_fused(kernels, plan_d or build_plan_d(), "D", 100))
    torch.cuda.empty_cache()
    runs.append(_sb_chain_vs_fused(kernels))
    torch.cuda.empty_cache()
    line = {"phase": "dfops_runs", "runs": runs}
    emit(line)
    return line


def _unpack_masks(masks: torch.Tensor, S: int) -> np.ndarray:
    """Device bit-packed [B, P, R, 128] int8 -> host [S, B, m] bool."""
    pk = masks.cpu().numpy().view(np.uint8)
    B, P, R, L = pk.shape
    pk = pk.reshape(B, P, R * L)
    return np.stack([(pk[:, s // 8] >> (s % 8)) & 1 for s in range(S)]).astype(bool)


def _check_k1(masks, kinds, dists, host_net, rng, what: str) -> None:
    """routed_apply == routed_apply_plain == apply_host, bit for bit, for
    one f32 plane, an f32 (hi, lo) pair and one f64 plane."""
    from lilac_tpu_torch.kernels import routed as rd

    B, _, R, _ = masks.shape
    m = R * 128
    for dtype, nplanes in ((np.float32, 1), (np.float32, 2), (np.float64, 1)):
        xs_np = [rng.standard_normal(m).astype(dtype) for _ in range(nplanes)]
        xs = [torch.as_tensor(x, device=DEVICE).view(R, 128) for x in xs_np]
        got = rd.routed_apply(xs, masks, kinds, dists)
        torch.cuda.synchronize()
        want = rd.routed_apply_plain(xs, masks, kinds, dists)
        for g, w, x_np in zip(got, want, xs_np):
            if not torch.equal(g, w):
                raise AssertionError(
                    f"routed_apply != plain ({what}, {dtype.__name__} x{nplanes})")
            host = host_net.apply_host(np.broadcast_to(x_np, (B, m)))
            if not np.array_equal(g.cpu().numpy().reshape(B, m), host):
                raise AssertionError(
                    f"routed_apply != apply_host ({what}, {dtype.__name__} x{nplanes})")


def _adj_planes(rng, shape, dtype, nplanes, dfpair):
    """Random per-net planes; a df64 pair gets a lo word below hi's last bit
    and a few signed zeros."""
    hi = rng.standard_normal(int(np.prod(shape))).astype(dtype).reshape(shape)
    hi[rng.random(shape) < 0.02] = -0.0
    xs = [hi]
    if nplanes == 2:
        xs.append((hi * dtype(2.0 ** -25)).astype(dtype) if dfpair
                  else rng.standard_normal(int(np.prod(shape))).astype(dtype).reshape(shape))
    return tuple(torch.as_tensor(x, device=DEVICE) for x in xs)


def _check_k11(masks, kinds, dists, idx, rng, what: str) -> None:
    """routed_apply_t == routed_apply_t_plain bit for bit in every value
    format, and == the transpose of the gather idx [B, m] the network
    encodes (index_add_ in f64; f32 planes to 1e-5, f64 and df64 to 1e-12
    of sum|u|)."""
    from lilac_tpu_torch.kernels import routed as rd

    B, _, R, _ = masks.shape
    flat = _net_offsets(idx)
    for dtype, nplanes, dfpair in ADJ_FORMATS + ((np.float64, 2, True),):
        xs = _adj_planes(rng, (B, R, 128), dtype, nplanes, dfpair)
        got = rd.routed_apply_t(xs, masks, kinds, dists, dfpair=dfpair)
        torch.cuda.synchronize()
        want = rd.routed_apply_t_plain(xs, masks, kinds, dists, dfpair=dfpair)
        fmt = f"{dtype.__name__} x{nplanes}{' df' if dfpair else ''}"
        if not all(_bits_equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"routed_apply_t != plain ({what}, {fmt})")
        tol = 1e-5 if dtype is np.float32 and not dfpair else 1e-12
        for g, x in zip(_numbers(got, dfpair), _numbers(xs, dfpair)):
            _check_transpose(g, flat, x, tol, f"routed_apply_t ({what}, {fmt})")


# K1 / K11 grids a call on the class C V plan (68 stages): the tile passes
# must cut them to at most this
MAX_CLASS_C_GRIDS = 8


def _grids_of_one_call(wrapper, call) -> int:
    """CUDA grids (passes) one call of a K1 / K11 wrapper launches, by its
    counter; the counters are put back as they were."""
    before = (wrapper.launches, wrapper.stage_launches)
    call()
    grids = wrapper.stage_launches - before[1]
    wrapper.launches, wrapper.stage_launches = before
    return grids


def _pass_times(rd, kinds, dists, m: int, B: int, tile: int, xs, us) -> list:
    """Each pass of a schedule timed on its own (K1 and K11 on the pass's
    stages alone, random masks of the plan's shape): where a call's time
    goes, by pass kind."""
    R = m // 128
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    out = []
    for kind, a, b in rd.routed_passes(tuple(kinds), tuple(dists), m, tile):
        ks, ds = tuple(kinds[a:b]), tuple(dists[a:b])
        mk = torch.randint(-128, 128, (B, (b - a + 7) // 8, R, 128), dtype=torch.int8,
                           device=DEVICE, generator=gen)
        out.append({"pass": [kind, a, b],
                    "k1_ms": time_ms(lambda: rd.routed_apply(xs, mk, ks, ds, tile=tile), 20),
                    "k11_ms": time_ms(lambda: rd.routed_apply_t(
                        us, mk, ks, ds, dfpair=True, tile=tile), 20)})
    return out


def _tile_sweep(call, want, tile: int, what: str) -> dict:
    """ms a call at the default tile's smaller powers of two (the C entry
    takes T from the wrapper), each result held bit for bit to `want`."""
    out = {}
    for t in (tile // 4, tile // 2):
        got = call(t)
        if not all(_bits_equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{what} at T={t} != plain")
        out[str(t)] = time_ms(lambda: call(t), 20)
    return out


K1_FORMATS = ((np.float32, 1), (np.float32, 2), (np.float64, 1), (np.float64, 2))


def phase_tiles() -> dict:
    """K1 and K11 at m = 2^16 with forced small tiles, so that every pass
    kind runs on the card: tile 128 (T^2/4 < m: stage passes beside low
    ones), 512 and 2048 (high tiles of 4 and 64 consecutive slots), 4096,
    and the default. On a monotone and a Benes network's schedules, with the
    network's own masks (K1 also == x[idx]) and with random masks, which
    switch halo slots on both sides and wrap tile 0's halo round the
    table's end; every value format the tile fits, bit for bit against the
    plain versions, and the grids a call against the pass count."""
    from lilac_tpu_torch.kernels import routed as rd
    from lilac_tpu_torch.kernels import routenet as rn

    rng = np.random.default_rng(17)
    m, B, ncol = 1 << 16, 3, 50000
    limit = rd.smem_optin_bytes(DEVICE)
    kinds_seen, checks, runs = set(), 0, []
    for mode in ("monotone", "benes"):
        idx = rng.integers(0, ncol, size=(B, m))
        net = rn.build_gather_network(idx, ncol, m, mode=mode)
        S = len(net.kinds)
        random_masks = torch.as_tensor(
            rng.integers(0, 256, size=(B, (S + 7) // 8, m // 128, 128),
                         dtype=np.uint8).view(np.int8), device=DEVICE)
        for masks_name, masks in (("network", rd.masks_device(net, DEVICE)),
                                  ("random", random_masks)):
            for tile in (128, 512, 2048, 4096, None):
                for dtype, nplanes in K1_FORMATS:
                    esize = np.dtype(dtype).itemsize
                    t = rd.routed_tile(nplanes, esize, limit) if tile is None else tile
                    if rd.routed_tile_smem(t, nplanes, esize) > limit:
                        continue
                    passes = rd.routed_passes(net.kinds, net.dists, m, t)
                    kinds_seen |= {p[0] for p in passes}
                    xs_np = [rng.standard_normal(m).astype(dtype) for _ in range(nplanes)]
                    xs = [torch.as_tensor(x, device=DEVICE).view(m // 128, 128)
                          for x in xs_np]
                    fmt = f"{dtype.__name__} x{nplanes}"
                    grids = _grids_of_one_call(rd.routed_apply, lambda: rd.routed_apply(
                        xs, masks, net.kinds, net.dists, tile=t))
                    got = rd.routed_apply(xs, masks, net.kinds, net.dists, tile=t)
                    torch.cuda.synchronize()
                    want = rd.routed_apply_plain(xs, masks, net.kinds, net.dists)
                    if grids != len(passes) or not all(
                            _bits_equal(g, w) for g, w in zip(got, want)):
                        raise AssertionError(
                            f"tiles: routed_apply != plain ({mode}, {masks_name} masks, "
                            f"T={t}, {fmt}, {grids} grids for {len(passes)} passes)")
                    if masks_name == "network" and not np.array_equal(
                            got[0].cpu().numpy().reshape(B, m), xs_np[0][idx]):
                        raise AssertionError(f"tiles: K1 does not gather ({mode}, T={t})")
                    checks += 1
                for dtype, nplanes, dfpair in ADJ_FORMATS + ((np.float64, 2, True),):
                    esize = np.dtype(dtype).itemsize
                    t = rd.routed_tile(nplanes, esize, limit) if tile is None else tile
                    if rd.routed_tile_smem(t, nplanes, esize) > limit:
                        continue
                    us = _adj_planes(rng, (B, m // 128, 128), dtype, nplanes, dfpair)
                    fmt = f"{dtype.__name__} x{nplanes}{' df' if dfpair else ''}"
                    grids = _grids_of_one_call(rd.routed_apply_t, lambda: rd.routed_apply_t(
                        us, masks, net.kinds, net.dists, dfpair=dfpair, tile=t))
                    got = rd.routed_apply_t(us, masks, net.kinds, net.dists,
                                            dfpair=dfpair, tile=t)
                    torch.cuda.synchronize()
                    want = rd.routed_apply_t_plain(us, masks, net.kinds, net.dists,
                                                   dfpair=dfpair)
                    n_pass = len(rd.routed_passes(net.kinds, net.dists, m, t))
                    if grids != n_pass or not all(
                            _bits_equal(g, w) for g, w in zip(got, want)):
                        raise AssertionError(
                            f"tiles: routed_apply_t != plain ({mode}, {masks_name} "
                            f"masks, T={t}, {fmt}, {grids} grids for {n_pass} passes)")
                    checks += 1
                if masks_name == "random":
                    t = tile or rd.routed_tile(2, 4, limit)
                    runs.append({"mode": mode, "tile": t, "stages": S, "passes": [
                        list(p) for p in rd.routed_passes(net.kinds, net.dists, m, t)]})
    if kinds_seen != set(rd.PASS_KINDS):
        raise AssertionError(f"tiles: pass kinds run {kinds_seen}")
    line = {"phase": "tiles", "m": m, "B": B, "checks": checks,
            "pass_kinds": sorted(kinds_seen), "schedules": runs}
    emit(line)
    return line


def phase_k11_small() -> dict:
    """K11 at m = 1024: a monotone network (all three stage kinds) and a
    Benes one, every value format, against the plain version and against
    the transpose of the gather."""
    from lilac_tpu_torch.kernels import routed as rd
    from lilac_tpu_torch.kernels import routenet as rn

    rng = np.random.default_rng(13)
    m, B, ncol = 1024, 3, 700
    checked = []
    for mode in ("monotone", "benes"):
        idx = rng.integers(0, ncol, size=(B, m))
        net = rn.build_gather_network(idx, ncol, m, mode=mode)
        if mode == "monotone" and set(net.kinds) != {"xor", "shift", "shiftl"}:
            raise AssertionError(f"expected all three stage kinds, got {set(net.kinds)}")
        _check_k11(rd.masks_device(net, DEVICE), net.kinds, net.dists,
                   torch.as_tensor(idx, device=DEVICE), rng, f"m={m} {mode}")
        checked.append({"kernel": "routed_apply_t", "m": m, "B": B, "mode": mode,
                        "stages": len(net.kinds)})
    line = {"phase": "k11_small", "checked": checked,
            "formats": ["float32 x1", "float32 x2", "float32 x2 df", "float64 x1",
                        "float64 x2 df"]}
    emit(line)
    return line


def _k2_bound(chunks):
    """K2's bound over [(K, R), ...] chunks: (ms, "bytes" | "operations", bytes)."""
    nbytes = sum(4 * K * R * 4 + 2 * R * 4 for K, R in chunks)
    # per term: TwoProd 17, cross terms 4, TwoSum 6, compensation 2
    flops = sum(29 * K * R + 6 * R for K, R in chunks)
    tb, tf = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return max(tb, tf), ("bytes" if tb >= tf else "operations"), nbytes


def _k2_product(dfk, args, what: str) -> dict:
    """Time K2 on one whole product (args: dfmulred_chunks' planes and
    table) beside the same sums one launch a chunk and a torch.cat, as the
    product was served before, and the plain version; the bound is
    _k2_bound's bytes and operations summed over the product's chunks. A
    class C product's 40 MB fit in L2, so its times are taken with L2
    flushed before each call (`warm_ms`: back to back)."""
    vh, vl, xh, xl, table = args
    per_chunk = []
    for slot0, rows, K, _ in table.spec:
        sl = slice(slot0, slot0 + K * rows)
        per_chunk.append(tuple(t[sl].view(K, rows) for t in (vh, vl, xh, xl)))

    def old_path():
        parts = [dfk.dfmulred(*a) for a in per_chunk]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])

    got = dfk.dfmulred_chunks(*args)
    if not all(_bits_equal(g, w) for g, w in zip(got, old_path())):
        raise AssertionError(f"K2 on {what}: one launch != one launch a chunk")
    bound_ms, bound_by, nbytes = _k2_bound([(K, rows) for _, rows, K, _ in table.spec])
    return {"ms": time_cold_ms(lambda: dfk.dfmulred_chunks(*args), 50),
            "warm_ms": time_ms(lambda: dfk.dfmulred_chunks(*args), 100),
            "per_chunk_ms": time_cold_ms(old_path, 50),
            "plain_ms": time_ms(lambda: dfk.dfmulred_chunks_plain(*args), 3),
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "chunks": len(table.spec), "rows": table.rows,
            "grid": [int(table.blocks.shape[0])], "threads": dfk.K2_ROWS}


def phase_kernels(plan_c) -> dict:
    """Each kernel against its plain version, at m = 1024, at synthetic
    class-C-sized networks with all three stage kinds, and on the class C
    plan itself (the shapes the main path gives it), where it is timed."""
    from lilac_tpu_torch.kernels import dfmulred as dfk
    from lilac_tpu_torch.kernels import routed as rd
    from lilac_tpu_torch.kernels import routed_spmv as rs
    from lilac_tpu_torch.kernels import routenet as rn
    from lilac_tpu_torch.ops.dfloat import split_f64_np

    rng = np.random.default_rng(7)
    checked = []

    # --- K1: small and class-C-sized synthetic networks ------------------
    for m, B, ncol in ((1024, 3, 700), (1 << 18, 10, 150000)):
        for mode in ("monotone", "benes"):
            if m > 1024 and mode == "benes":
                continue  # the class-C-sized plan below is one more shape
            idx = rng.integers(0, ncol, size=(B, m))
            net = rn.build_gather_network(idx, ncol, m, mode=mode)
            if mode == "monotone" and set(net.kinds) != {"xor", "shift", "shiftl"}:
                raise AssertionError(f"expected all three stage kinds, got {set(net.kinds)}")
            masks = rd.masks_device(net, DEVICE)
            _check_k1(masks, net.kinds, net.dists, net, rng, f"m={m} {mode}")
            # the network really gathers: out[b, k] = x[idx[b, k]]
            x = rng.standard_normal(m).astype(np.float32)
            (out,) = rd.routed_apply(
                [torch.as_tensor(x, device=DEVICE).view(m // 128, 128)],
                masks, net.kinds, net.dists)
            if not np.array_equal(out.cpu().numpy().reshape(B, m), x[idx]):
                raise AssertionError(f"network does not gather (m={m} {mode})")
            checked.append({"kernel": "routed_apply", "m": m, "B": B,
                            "mode": mode, "stages": len(net.kinds)})
            del masks, net

    # --- K1 on the class C plan: equality and time -------------------------
    V = plan_c.A.V
    S = len(V.kinds)
    B, P, R, _ = V.masks.shape
    m = V.m
    host_net = rn.GatherPlanHost(V.kinds, V.dists, _unpack_masks(V.masks, S), m)
    _check_k1(V.masks, V.kinds, V.dists, host_net, rng, "class C V plan")
    checked.append({"kernel": "routed_apply", "m": m, "B": B,
                    "mode": "class C V plan", "stages": S,
                    "kinds": sorted(set(V.kinds))})
    xh = torch.as_tensor(rng.standard_normal(m).astype(np.float32), device=DEVICE).view(R, 128)
    xl = (xh * 2.0 ** -25).contiguous()
    tile_c = rd.routed_tile(2, 4, rd.smem_optin_bytes(DEVICE))
    passes_c = rd.routed_passes(V.kinds, V.dists, m, tile_c)
    k1_grids = _grids_of_one_call(
        rd.routed_apply, lambda: rd.routed_apply([xh, xl], V.masks, V.kinds, V.dists))
    if k1_grids != len(passes_c) or k1_grids > MAX_CLASS_C_GRIDS:
        raise AssertionError(f"K1 on the class C V plan: {k1_grids} grids a call "
                             f"({len(passes_c)} passes, at most {MAX_CLASS_C_GRIDS})")
    k1_ms = time_ms(lambda: rd.routed_apply([xh, xl], V.masks, V.kinds, V.dists), 20)
    k1_by_tile = _tile_sweep(
        lambda t: rd.routed_apply([xh, xl], V.masks, V.kinds, V.dists, tile=t),
        rd.routed_apply_plain([xh, xl], V.masks, V.kinds, V.dists), tile_c, "K1")
    k1_plain_ms = time_ms(
        lambda: rd.routed_apply_plain([xh, xl], V.masks, V.kinds, V.dists), 3)
    # the composed gather out[b, k] = x[idx[b, k]] as one indexing call, the
    # library time of K1 (other inputs: it needs idx, which the network
    # encodes), as index_add_ on the same index is K11's
    iota = torch.arange(m, dtype=torch.float32, device=DEVICE).view(R, 128)
    (routed_iota,) = rd.routed_apply([iota], V.masks, V.kinds, V.dists)
    gidx = routed_iota.view(B, m).to(torch.int64)
    xh_f, xl_f = xh.view(m), xl.view(m)
    gather_ms = time_ms(lambda: (xh_f[gidx], xl_f[gidx]), 20)
    oh, ol = rd.routed_apply([xh, xl], V.masks, V.kinds, V.dists)
    if not (torch.equal(oh.view(B, m), xh_f[gidx]) and torch.equal(ol.view(B, m), xl_f[gidx])):
        raise AssertionError("class C V network differs from its composed gather")
    k1_bytes = 2 * m * 4 + B * P * m + 2 * B * m * 4
    k1 = {
        "name": "routed_apply", "route": "cuda",
        "source": "lilac_tpu_torch/csrc/routed.cu",
        "replaces": "lilac_tpu/kernels/routed.py:141",
        "launches": 0, "max_abs_err": 0.0,
        "ms": k1_ms, "plain_ms": k1_plain_ms,
        "bound_ms": k1_bytes / PEAK_BYTES_S * 1e3, "bound_by": "bytes",
        "library_ms": gather_ms,
        "library": "x[idx] on the composed index, per plane (other inputs: it needs idx)",
        "shape": {"m": m, "B": B, "stages": S, "planes": 2, "dtype": "float32"},
        "bytes": k1_bytes, "tile": tile_c, "grids_per_call": k1_grids,
        "ms_by_tile": k1_by_tile,
        "passes": [list(p) for p in passes_c],
    }

    # --- K11 on the class C plan: V's own network in reverse ----------------
    # (monotone: xor, shift and shiftl stages; a df64 pair per net)
    _check_k11(V.masks, V.kinds, V.dists, gidx, rng, "class C V plan")
    checked.append({"kernel": "routed_apply_t", "m": m, "B": B,
                    "mode": "class C V plan", "stages": S,
                    "kinds": sorted(set(V.kinds))})
    uh, ul = _adj_planes(rng, (B, R, 128), np.float32, 2, True)
    k11_grids = _grids_of_one_call(rd.routed_apply_t, lambda: rd.routed_apply_t(
        [uh, ul], V.masks, V.kinds, V.dists, dfpair=True))
    if k11_grids != len(passes_c) or k11_grids > MAX_CLASS_C_GRIDS:
        raise AssertionError(f"K11 on the class C V plan: {k11_grids} grids a call "
                             f"({len(passes_c)} passes, at most {MAX_CLASS_C_GRIDS})")
    k11_ms = time_ms(lambda: rd.routed_apply_t(
        [uh, ul], V.masks, V.kinds, V.dists, dfpair=True), 20)
    k11_by_tile = _tile_sweep(
        lambda t: rd.routed_apply_t([uh, ul], V.masks, V.kinds, V.dists, dfpair=True,
                                    tile=t),
        rd.routed_apply_t_plain([uh, ul], V.masks, V.kinds, V.dists, dfpair=True),
        tile_c, "K11")
    by_pass = _pass_times(rd, V.kinds, V.dists, m, B, tile_c, [xh, xl], [uh, ul])
    k11_plain_ms = time_ms(lambda: rd.routed_apply_t_plain(
        [uh, ul], V.masks, V.kinds, V.dists, dfpair=True), 3)
    flat = _net_offsets(gidx)
    k11_lib_ms = time_ms(lambda: (_index_add(flat, uh), _index_add(flat, ul)), 20)
    k11_bytes = 2 * 2 * B * m * 4 + B * P * m
    k11 = {
        "name": "routed_apply_t", "route": "cuda",
        "source": "lilac_tpu_torch/csrc/adjoint.cu",
        "replaces": "lilac_tpu/kernels/routed.py:287",
        "launches": 0, "max_abs_err": 0.0,
        "ms": k11_ms, "plain_ms": k11_plain_ms,
        "bound_ms": k11_bytes / PEAK_BYTES_S * 1e3, "bound_by": "bytes",
        "library_ms": k11_lib_ms,
        "library": "index_add_ on the composed index, once per plane (other "
                   "inputs: it needs idx; uncompensated)",
        "shape": {"m": m, "B": B, "stages": S, "planes": 2, "dtype": "float32",
                  "dfpair": True},
        "bytes": k11_bytes, "tile": tile_c, "grids_per_call": k11_grids,
        "ms_by_tile": k11_by_tile,
        "passes": [list(p) for p in reversed(passes_c)],
    }
    del flat, uh, ul

    # --- K2: against plain and numpy f64 at K in {1, 16, 35} ----------------
    k2_err = 0.0
    R_c, K_c = V.chunks[0]
    shapes = [(1, 4096), (16, 4096), (35, 4096), (K_c, R_c)]
    shapes += [(k, r) for r, k in plan_c.A.VT.chunks[:1]]
    for K, Rr in shapes:
        v = rng.standard_normal((K, Rr)) * np.exp(rng.uniform(-8, 8, (K, Rr)))
        x = rng.standard_normal((K, Rr))
        vs, xs = split_f64_np(v), split_f64_np(x)
        args = [torch.as_tensor(np.ascontiguousarray(a), device=DEVICE)
                for a in (vs[..., 0], vs[..., 1], xs[..., 0], xs[..., 1])]
        gh, gl = dfk.dfmulred(*args)
        torch.cuda.synchronize()
        ph, pl_ = dfk.dfmulred_plain(*args)
        if not torch.equal(gh, ph):
            raise AssertionError(f"dfmulred hi != plain hi (K={K}, R={Rr})")
        got = gh.cpu().numpy().astype(np.float64) + gl.cpu().numpy().astype(np.float64)
        plain = ph.cpu().numpy().astype(np.float64) + pl_.cpu().numpy().astype(np.float64)
        # the df inputs as exact f64 values: the reference sum in f64
        v64 = vs[..., 0].astype(np.float64) + vs[..., 1]
        x64 = xs[..., 0].astype(np.float64) + xs[..., 1]
        exact = (v64 * x64).sum(axis=0)
        tol = 1e-13 * np.abs(v64 * x64).sum(axis=0)
        if not (np.abs(got - plain) <= tol).all():
            raise AssertionError(f"dfmulred != plain beyond 1e-13 (K={K}, R={Rr})")
        if not (np.abs(got - exact) <= tol).all():
            raise AssertionError(f"dfmulred != numpy f64 beyond 1e-13 (K={K}, R={Rr})")
        k2_err = max(k2_err, float(np.abs(got - plain).max()))
        checked.append({"kernel": "dfmulred", "K": K, "R": Rr})
    # interleaved (hi, lo) values, read in place as the plan stores them
    vals0 = V.vals[0, : R_c * K_c]
    o_h = torch.as_tensor(rng.standard_normal(R_c * K_c).astype(np.float32), device=DEVICE)
    o_l = (o_h * 2.0 ** -26).contiguous()
    k2_args = (vals0[:, 0].view(K_c, R_c), vals0[:, 1].view(K_c, R_c),
               o_h.view(K_c, R_c), o_l.view(K_c, R_c))
    gh, gl = dfk.dfmulred(*k2_args)
    ph, pl_ = dfk.dfmulred_plain(*k2_args)
    if not (torch.equal(gh, ph) and torch.equal(gl, pl_)):
        raise AssertionError("dfmulred != plain on the class C plan's values")
    chunk_ms = time_ms(lambda: dfk.dfmulred(*k2_args), 200)
    chunk_bound_ms, _, chunk_bytes = _k2_bound([(K_c, R_c)])
    # --- K2 over whole products: V's and V^T's chunks in one launch each ----
    products = {}
    for label, M in (("V", V), ("VT", plan_c.A.VT)):
        table = rs._single_table_k2(M.chunks, M.m)
        vflat = M.vals.reshape(-1, 2)
        ph = torch.as_tensor(rng.standard_normal(vflat.shape[0]).astype(np.float32),
                             device=DEVICE)
        pl_ = (ph * 2.0 ** -26).contiguous()
        args = (vflat[:, 0], vflat[:, 1], ph, pl_, table)
        got = dfk.dfmulred_chunks(*args)
        want = dfk.dfmulred_chunks_plain(*args)
        if not all(_bits_equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"dfmulred_chunks != plain on the class C {label} product")
        products[label] = _k2_product(dfk, args, f"class C {label}")
        checked.append({"kernel": "dfmulred", "product": f"class C {label}",
                        "chunks": len(M.chunks), "rows": table.rows})
    k2 = {
        "name": "dfmulred", "route": "cuda",
        "source": "lilac_tpu_torch/csrc/dfmulred.cu",
        "replaces": "lilac_tpu/kernels/dfmulred.py:94",
        "launches": 0, "max_abs_err": k2_err,
        "ms": products["V"]["ms"], "plain_ms": products["V"]["plain_ms"],
        "bound_ms": products["V"]["bound_ms"], "bound_by": products["V"]["bound_by"],
        "library_ms": None,
        "library": "none: no single PyTorch call computes a df64 dot2",
        "shape": {"product": "class C V, all chunks in one launch",
                  "chunks": products["V"]["chunks"], "rows": products["V"]["rows"],
                  "dtype": "float32 (hi, lo)"},
        "bytes": products["V"]["bytes"], "products": products,
        "chunk_ms": chunk_ms, "chunk_bound_ms": chunk_bound_ms,
        "chunk_shape": {"K": K_c, "R": R_c}, "chunk_bytes": chunk_bytes,
    }
    emit({"phase": "kernels", "checked": checked,
          "grids_per_call": {"routed_apply": k1_grids, "routed_apply_t": k11_grids},
          "ms_by_pass": by_pass,
          "times_ms": {"routed_apply": k1_ms, "routed_apply_plain": k1_plain_ms,
                       "routed_apply_index_gather": gather_ms,
                       "routed_apply_t": k11_ms, "routed_apply_t_plain": k11_plain_ms,
                       "routed_apply_t_index_add": k11_lib_ms,
                       "dfmulred_chunk": chunk_ms, "dfmulred_products": products}})
    return {"routed_apply": k1, "dfmulred": k2, "routed_apply_t": k11}


# ---------------------------------------------------------------------------
# hierarchical networks: kernels K3-K6 (net-batched) and K3u-K6u (one net)
# ---------------------------------------------------------------------------

# pass kind -> (net-batched wrapper, un-batched wrapper, plain version)
PASS_FNS = {
    "inner": ("routed_apply_sliced_b", "routed_apply_sliced",
              "routed_apply_sliced_plain"),
    "butterfly": ("butterfly_apply_b", "butterfly_apply", "butterfly_apply_plain"),
    "window": ("window_shift_apply_b", "window_shift_apply",
               "window_shift_apply_plain"),
    "bigshift": ("bigshift_apply_b", "bigshift_apply", "bigshift_apply_plain"),
}
# line of the pl.pallas_call each wrapper's TPU kernel reaches
REPLACES = {
    "routed_apply_sliced_b": 976, "butterfly_apply_b": 1094,
    "window_shift_apply_b": 1182, "bigshift_apply_b": 1255,
    "routed_apply_sliced": 398, "butterfly_apply": 503,
    "window_shift_apply": 591, "bigshift_apply": 662,
    "routed_apply_sliced_bt": 1490, "butterfly_apply_bt": 1602,
    "window_shift_apply_bt": 1709, "bigshift_apply_bt": 1806,
}
FORMATS = ((np.float32, 1), (np.float32, 2), (np.float64, 1))
# pass kind -> (adjoint wrapper, plain version); net-batched only, one net is N = 1
ADJ_FNS = {
    "inner": ("routed_apply_sliced_bt", "routed_apply_sliced_bt_plain"),
    "butterfly": ("butterfly_apply_bt", "butterfly_apply_bt_plain"),
    "window": ("window_shift_apply_bt", "window_shift_apply_bt_plain"),
    "bigshift": ("bigshift_apply_bt", "bigshift_apply_bt_plain"),
}
ADJ_NAMES = [ADJ_FNS[k][0] for k in ADJ_FNS]
# adjoint value formats: (dtype, planes, dfpair); a pair adds plane by plane
# or, as one df64 (hi, lo) number, compensated
ADJ_FORMATS = ((np.float32, 1, False), (np.float32, 2, False), (np.float32, 2, True),
               (np.float64, 1, False))


def _inner_row(rd, row, planes, meta, bl: int, N: int, m: int) -> None:
    """An inner-pass row gets its launch configuration, as the card reports
    it for the kernel's instantiation."""
    row["launch"] = rd.inner_launch_config(
        len(planes), planes[0].element_size(), bl, meta[2], N=N, nblocks=m // bl)


def _window_spans(bl: int) -> list:
    return [1 << j for j in range(7, 13) if (1 << j) <= bl]


def _call_pass(fn, meta, planes, mk, bl, layout):
    """One pass through `fn` (a wrapper or a plain version): (planes,
    layout the next pass reads through; None = natural order)."""
    kind = meta[0]
    if kind == "inner":
        return fn(planes, mk, meta[1], meta[2], layout=layout), None
    if kind == "butterfly":
        out, lay = fn(planes, mk, meta[1], bl, layout=layout)
        return out, (None if tuple(lay) == tuple(range(len(lay))) else tuple(lay))
    return fn(planes, mk, meta[1], bl, layout=layout), None


EXCHANGE_LIBRARY = "x[idx] on the index the pass composes, per plane (other inputs: it needs idx)"


def _composed_gather_ms(run_pass, planes, got, what: str, reps: int) -> float:
    """The library time of an exchange pass: x[idx] on the index it
    composes. Routing the slot numbers (an f64 iota, exact) through the
    pass with the same masks and layout gives idx with out = x.flat[idx];
    the gather must equal the kernel's output `got` bit for bit."""
    iota = torch.arange(planes[0].numel(), dtype=torch.float64,
                        device=DEVICE).view(planes[0].shape)
    (routed,) = run_pass((iota,))
    idx = routed.to(torch.int64)
    del routed, iota
    flat = [p.reshape(-1) for p in planes]
    if not all(_bits_equal(f[idx], g) for f, g in zip(flat, got)):
        raise AssertionError(f"{what}: the pass differs from its composed gather")
    return time_ms(lambda: [f[idx] for f in flat], reps)


def _walk_schedule(rd, planes, metas, masks, bl, batched: bool, what: str,
                   timed: dict | None = None, reps: int = 10) -> tuple:
    """Run a pass schedule through the kernels, holding EVERY pass bit for
    bit against its plain version on the same input and layout. With
    `timed` (a dict), one pass of each kind is also timed (kernel and plain)
    and its row written there under the wrapper's name: the first one, or
    the second where the first is the schedule's opening pass, whose input
    is the one plane all nets share and not a plane per net as in every
    later pass. Returns the planes after the last pass and their layout."""
    layout = None
    N = masks[0].shape[0] if batched and masks else 1
    kinds = [meta[0] for meta in metas]
    for j, (meta, mk) in enumerate(zip(metas, masks)):
        kind = meta[0]
        name_b, name_u, name_p = PASS_FNS[kind]
        name = name_b if batched else name_u
        fn, plain = getattr(rd, name), getattr(rd, name_p)
        got, new_layout = _call_pass(fn, meta, planes, mk, bl, layout)
        torch.cuda.synchronize()
        want, plain_layout = _call_pass(plain, meta, planes, mk, bl, layout)
        if new_layout != plain_layout:
            raise AssertionError(f"{what}: pass {j} {name} layout {new_layout} "
                                 f"!= plain {plain_layout}")
        for g, w in zip(got, want):
            if g.shape != w.shape or not torch.equal(g, w):
                raise AssertionError(
                    f"{what}: pass {j} {name} != {name_p} (layout {layout})")
        del want
        opening = batched and j == 0 and kind in kinds[1:]
        if timed is not None and name not in timed and not opening:
            esize = planes[0].element_size()
            m = planes[0].shape[-2] * 128
            mask_bytes = mk.numel()
            if kind == "window":  # a block's own masks and the sum(d) just left of them
                mask_bytes = mk.numel() // 2 + N * (m // bl) * min(sum(meta[1]), bl)
            nbytes = (sum(p.numel() for p in planes) * esize + mask_bytes
                      + N * m * esize * len(planes))
            ms = time_ms(lambda: _call_pass(fn, meta, planes, mk, bl, layout), reps)
            plain_ms = time_ms(
                lambda: _call_pass(plain, meta, planes, mk, bl, layout), 2)
            library_ms = _composed_gather_ms(
                lambda ps: _call_pass(fn, meta, ps, mk, bl, layout)[0], planes, got,
                f"{what}: pass {j} {name}", reps)
            timed[name] = {
                "name": name, "route": "cuda",
                "source": "lilac_tpu_torch/csrc/hier.cu",
                "replaces": f"lilac_tpu/kernels/routed.py:{REPLACES[name]}",
                "launches": 0, "max_abs_err": 0.0,
                "ms": ms, "plain_ms": plain_ms,
                "bound_ms": nbytes / PEAK_BYTES_S * 1e3, "bound_by": "bytes",
                "library_ms": library_ms, "library": EXCHANGE_LIBRARY,
                "shape": {"m": m, "N": N, "bl": bl, "planes": len(planes),
                          "dtype": str(planes[0].dtype).replace("torch.", ""),
                          "input": "shared" if planes[0].dim() == 2 and batched
                          else "per net", "pass": [str(v) for v in meta],
                          "read_layout": layout},
                "bytes": nbytes, "timed_on": what,
            }
            if kind == "inner":
                _inner_row(rd, timed[name], planes, meta, bl, N, m)
            if kind == "window":
                timed[name]["launch"] = rd.window_launch_config(bl, meta[1], N=N,
                                                                nblocks=m // bl)
            if kind in ("butterfly", "bigshift"):
                timed[name]["launch"] = _exchange_launch(rd, meta, planes, N, m, bl)
                if not batched:
                    # one net's 8.9 MB stay in L2 between back-to-back calls
                    timed[name].update(
                        warm_ms=ms, ms=time_cold_ms(
                            lambda: _call_pass(fn, meta, planes, mk, bl, layout), reps),
                        copy_ms=_copy_ms(nbytes, reps),
                        copy_warm_ms=_copy_ms(nbytes, reps, warm=True))
        planes, layout = got, new_layout
    return planes, layout


def _exchange_launch(rd, meta, planes, N: int, m: int, bl: int) -> dict:
    """The launch shape of a butterfly (K4, K4u, K8) or block-aligned shift
    (K6, K6u) pass, as the wrapper chooses it on this card."""
    g = len(meta[1]) if meta[0] == "butterfly" else 0
    return rd.butterfly_launch_config(
        N, (m // bl) >> g, bl, g, len(planes), planes[0].element_size(),
        torch.cuda.get_device_properties(0).multi_processor_count)


def _copy_ms(nbytes: int, reps: int, warm: bool = False) -> float:
    """A torch.Tensor.copy_ that moves `nbytes` (half read, half written),
    flushed (or back to back): the practical floor of a pass that moves as
    many."""
    src = torch.ones(nbytes // 2, dtype=torch.uint8, device=DEVICE)
    dst = torch.empty_like(src)
    return (time_ms if warm else time_cold_ms)(lambda: dst.copy_(src), reps)


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Same shape and the same bits (torch.equal would pass -0.0 for 0.0)."""
    as_int = torch.int32 if a.element_size() == 4 else torch.int64
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(as_int), b.contiguous().view(as_int))


def _bits_diff(got, want, show: int = 4) -> list:
    """Where two lists of planes differ in their bits: per plane the count,
    the first positions and both words there, for a failure's message."""
    out = []
    for g, w in zip(got, want):
        as_int = torch.int32 if g.element_size() == 4 else torch.int64
        gi, wi = g.contiguous().view(as_int).reshape(-1), w.contiguous().view(as_int).reshape(-1)
        bad = (gi != wi).nonzero().reshape(-1)
        out.append({"differ": int(bad.numel()), "at": bad[:show].tolist(),
                    "got": [hex(v) for v in gi[bad[:show]].tolist()],
                    "want": [hex(v) for v in wi[bad[:show]].tolist()]})
    return out


def _call_pass_t(fn, meta, planes, mk, bl, layout, dfpair):
    """One ADJOINT pass through `fn` (a wrapper or a plain version)."""
    kind = meta[0]
    if kind == "butterfly":  # a pure permutation: no merge, no dfpair
        out, lay = fn(planes, mk, meta[1], bl, layout=layout)
        return out, (None if tuple(lay) == tuple(range(len(lay))) else tuple(lay))
    if kind == "inner":
        return fn(planes, mk, meta[1], meta[2], dfpair=dfpair, layout=layout), None
    return fn(planes, mk, meta[1], bl, dfpair=dfpair, layout=layout), None


def _net_offsets(idx: torch.Tensor) -> torch.Tensor:
    """idx [N, m] per-net slot numbers -> flat [N * m] into an [N * m] vector."""
    N, m = idx.shape
    return (idx + torch.arange(N, device=idx.device).view(N, 1) * m).reshape(-1)


def _index_add(flat_idx, values: torch.Tensor) -> torch.Tensor:
    """The transpose of out = x[idx] as PyTorch's one call: zeros.index_add_."""
    return torch.zeros(flat_idx.numel(), dtype=values.dtype,
                       device=values.device).index_add_(0, flat_idx, values.reshape(-1))


def _numbers(planes, dfpair: bool) -> list:
    """Planes grouped by the numbers they hold: one df64 (hi, lo) pair, or
    every plane a number of its own."""
    return [tuple(planes)] if dfpair else [(p,) for p in planes]


def _df_sum64(planes) -> torch.Tensor:
    return sum(p.to(torch.float64) for p in planes)


def _check_transpose(got_planes, flat_idx, u_planes, tol: float, what: str) -> float:
    """got == G^T u in f64 to tol * (G^T |u|), G the gather flat_idx encodes."""
    u64 = _df_sum64(u_planes).reshape(-1)
    want = _index_add(flat_idx, u64)
    scale = _index_add(flat_idx, u64.abs())
    err = (_df_sum64(got_planes).reshape(-1) - want).abs()
    worst = float((err / scale.clamp_min(1e-300)).max())
    if not bool((err <= tol * scale).all()):
        raise AssertionError(f"{what}: G^T u differs from index_add_ by {worst:.3e} "
                             f"of sum|u| (tolerance {tol})")
    return worst


def _walk_schedule_t(rd, planes, metas, masks, bl, dfpair: bool, what: str,
                     timed: dict | None = None, reps: int = 10) -> tuple:
    """Run a pass schedule IN REVERSE through the adjoint kernels, holding
    every pass bit for bit against its plain version on the same per-net
    input and the layout the reversed schedule really meets. With `timed`,
    the first pass of each kind is timed (kernel, plain, and for the merging
    passes index_add_ on the index the pass composes: the one PyTorch call
    that computes the same sums, given an index the kernel does not need)
    and its row written under the wrapper's name."""
    layout = None
    N = masks[0].shape[0]
    for j in range(len(metas) - 1, -1, -1):
        meta, mk = metas[j], masks[j]
        kind = meta[0]
        name, name_p = ADJ_FNS[kind]
        fn, plain = getattr(rd, name), getattr(rd, name_p)
        got, new_layout = _call_pass_t(fn, meta, planes, mk, bl, layout, dfpair)
        torch.cuda.synchronize()
        want, plain_layout = _call_pass_t(plain, meta, planes, mk, bl, layout, dfpair)
        if new_layout != plain_layout:
            raise AssertionError(f"{what}: pass {j} {name} layout {new_layout} "
                                 f"!= plain {plain_layout}")
        for g, w in zip(got, want):
            if not _bits_equal(g, w):
                raise AssertionError(
                    f"{what}: pass {j} {name} != {name_p} (layout {layout})")
        del want
        if timed is not None and name not in timed:
            esize = planes[0].element_size()
            m = planes[0].shape[-2] * 128
            # the window adjoint reads only the masks' self halves
            mask_bytes = mk.numel() // 2 if kind == "window" else mk.numel()
            nbytes = 2 * N * m * esize * len(planes) + mask_bytes
            ms = time_ms(lambda: _call_pass_t(fn, meta, planes, mk, bl, layout, dfpair),
                         reps)
            plain_ms = time_ms(
                lambda: _call_pass_t(plain, meta, planes, mk, bl, layout, dfpair), 2)
            library = "index_add_ on the index the pass composes, once per plane"
            if kind in ("inner", "butterfly"):  # exchanges: a gather
                library = EXCHANGE_LIBRARY
                library_ms = _composed_gather_ms(
                    lambda ps: _call_pass_t(fn, meta, ps, mk, bl, layout, False)[0],
                    planes, got, f"{what}: pass {j} {name}", reps)
            else:
                # the index the pass composes, from routing the slot numbers
                # forwards (exact in f32 up to 2^24), natural layout
                iota = torch.arange(m, dtype=torch.float32, device=DEVICE).view(-1, 128)
                (routed,), _ = _call_pass(
                    getattr(rd, PASS_FNS[kind][0]), meta, (iota,), mk, bl, None)
                flat = _net_offsets(routed.view(N, m).to(torch.int64))
                del routed
                nat, _ = _call_pass_t(fn, meta, planes, mk, bl, None, dfpair)
                _check_transpose(nat, flat, planes, 1e-12, f"{what}: pass {j} {name}")
                del nat
                library_ms = time_ms(lambda: [_index_add(flat, p) for p in planes], reps)
                del flat
            timed[name] = {
                "name": name, "route": "cuda",
                "source": "lilac_tpu_torch/csrc/"
                          + ("hier.cu" if kind in ("inner", "butterfly") else "adjoint.cu"),
                "replaces": f"lilac_tpu/kernels/routed.py:{REPLACES[name]}",
                "launches": 0, "max_abs_err": 0.0,
                "ms": ms, "plain_ms": plain_ms,
                "bound_ms": nbytes / PEAK_BYTES_S * 1e3, "bound_by": "bytes",
                "library_ms": library_ms, "library": library,
                "shape": {"m": m, "N": N, "bl": bl, "planes": len(planes),
                          "dtype": str(planes[0].dtype).replace("torch.", ""),
                          "dfpair": dfpair, "pass": [str(v) for v in meta],
                          "read_layout": layout},
                "bytes": nbytes, "timed_on": what,
            }
            if kind == "inner":
                _inner_row(rd, timed[name], planes, meta, bl, N, m)
            if kind == "window":
                timed[name]["launch"] = rd.window_bt_launch_config(
                    bl, meta[1], len(planes), esize, N=N, nblocks=m // bl)
            if kind == "butterfly":
                timed[name]["launch"] = _exchange_launch(rd, meta, planes, N, m, bl)
        planes, layout = got, new_layout
    return planes, layout


def _plane(x: torch.Tensor, m: int) -> torch.Tensor:
    """A vector zero-padded to m slots as one [m // 128, 128] plane."""
    return torch.nn.functional.pad(x, (0, m - x.shape[0])).view(m // 128, 128)


def _reset_hier_counts(rd, dfk) -> None:
    for w in rd.HIER_WRAPPERS:
        w.launches = 0
    for w in (rd.routed_apply, rd.routed_apply_t):
        w.launches = 0
        w.stage_launches = 0
    dfk.dfmulred.launches = 0
    from lilac_tpu_torch.kernels import dfdot as kd
    kd.dfdot.launches = 0
    _reset_dfops_counts()


def _check_dfdot(kernels: dict, res, class_name: str) -> int:
    """dfdot's launches in an NPB df64 run just made, held to the steps run
    (its warm-up step included): 54 dots a step (rho, two in each of the 25
    CG iterations, the residual's, norm1, norm2), each two launches where
    the library splits the tree, one where it does not. Into the `kernels`
    line's dfdot row."""
    from lilac_tpu_torch.generate.npb import CLASSES
    from lilac_tpu_torch.kernels import dfdot as kd

    depth = kd.kernel_depth(CLASSES[class_name].na,
                            kd.device_sms(torch.cuda.current_device()))
    got = kd.dfdot.launches
    want = (res.niter + 1) * 54 * (2 if depth else 1)
    if got != want:
        raise AssertionError(f"dfdot launched {got} times in {res.niter + 1} outer "
                             f"steps of class {class_name} ({want} expected)")
    row = kernels.setdefault("dfdot", {"name": "dfdot", "launches": 0})
    row[f"launches_class_{class_name.lower()}"] = got
    row["launches"] += got
    return got


def _hier_counts(rd) -> dict:
    return {w.__name__: w.launches for w in rd.HIER_WRAPPERS}


def _planes_for(rng, m, dtype, nplanes, lead=()):
    shape = tuple(lead) + (m // 128, 128)
    xs = [rng.standard_normal(int(np.prod(shape))).astype(dtype).reshape(shape)
          for _ in range(nplanes)]
    return xs, tuple(torch.as_tensor(x, device=DEVICE) for x in xs)


def phase_hier_small() -> dict:
    """K3-K6 and K3u-K6u at a small size (bl = 256, m = 8192: 5 block bits).

    (a) every kernel on random masks, read through the identity and through
    a scrambled block layout, input shared by the nets and per net, in all
    three word formats, bit for bit against its plain version;
    (b) real schedules from compile_hier at gmax 1, 2, 3 (one column dense
    enough for block-aligned shifts): every pass against its plain version,
    and hier_apply_batched / hier_apply against the numpy applier of the
    network and against x[idx].
    The adjoint kernels K7-K10 likewise: (a) on the same random masks with
    per-net planes, N = 3 and N = 1, every value format; (b) the same
    schedules in reverse, pass by pass, and hier_apply_batched_t against the
    transpose of the gather (index_add_ in f64)."""
    from lilac_tpu_torch.kernels import routed as rd
    from lilac_tpu_torch.kernels import routenet as rn

    rng = np.random.default_rng(11)
    bl, m, N = 256, 8192, 3
    nblocks, R = m // bl, bl // 128
    checks = adj_checks = 0

    def rand_mask(shape, bits):
        return torch.as_tensor(
            rng.integers(0, 1 << bits, size=shape, dtype=np.uint8).view(np.int8),
            device=DEVICE)

    inner_d = (1, 128, 2, 64, 4, 32, 8, 16, 1, 128)
    cases = [
        (("inner", ("xor",) * len(inner_d), inner_d), (nblocks, 2, R, 128), 8),
        (("butterfly", (3,)), (nblocks // 2, 2 * R, 128), 1),
        (("butterfly", (4, 0)), (nblocks // 4, 4 * R, 128), 2),
        (("butterfly", (1, 4, 2)), (nblocks // 8, 8 * R, 128), 3),
        (("window", (1, 2, 4, 8, 16, 32, 64, 100)), (nblocks, 2 * R, 128), 8),
        (("window", (255,)), (nblocks, 2 * R, 128), 1),
        (("bigshift", 3 * bl), (nblocks, R, 128), 1),
        (("bigshift", 16 * bl), (nblocks, R, 128), 1),
    ]
    for meta, mshape, bits in cases:
        name_b, name_u, name_p = PASS_FNS[meta[0]]
        plain = getattr(rd, name_p)
        for layout in (None, (3, 0, 4, 1, 2)):
            for dtype, nplanes in FORMATS:
                for batched, per_net in ((True, False), (True, True), (False, False)):
                    mk = rand_mask(((N,) if batched else ()) + mshape, bits)
                    _, planes = _planes_for(
                        rng, m, dtype, nplanes, (N,) if per_net else ())
                    fn = getattr(rd, name_b if batched else name_u)
                    got, lay = _call_pass(fn, meta, planes, mk, bl, layout)
                    torch.cuda.synchronize()
                    want, lay_p = _call_pass(plain, meta, planes, mk, bl, layout)
                    if lay != lay_p or not all(
                            torch.equal(g, w) for g, w in zip(got, want)):
                        raise AssertionError(
                            f"small: {fn.__name__} != {name_p} ({meta[:2]}, layout "
                            f"{layout}, {dtype.__name__} x{nplanes}, per_net={per_net})")
                    checks += 1
            if meta[0] in ("butterfly", "bigshift"):
                # every launch shape (slots, threads) the kernel takes within bl
                for shape in EXCHANGE_SHAPES:
                    if shape[0] * shape[1] > bl:
                        continue
                    for dtype, nplanes in FORMATS:
                        mk = rand_mask((N,) + mshape, bits)
                        _, planes = _planes_for(rng, m, dtype, nplanes, (N,))
                        fn = functools.partial(getattr(rd, name_b), launch=shape)
                        got, lay = _call_pass(fn, meta, planes, mk, bl, layout)
                        want, lay_p = _call_pass(plain, meta, planes, mk, bl, layout)
                        if lay != lay_p or not all(
                                _bits_equal(g, w) for g, w in zip(got, want)):
                            raise AssertionError(
                                f"small: {name_b} at launch {shape} != {name_p} "
                                f"({meta[:2]}, layout {layout}, {dtype.__name__} x{nplanes})")
                        checks += 1
            # the adjoint pass on the same masks: per-net planes, N nets and one
            name_t, name_tp = ADJ_FNS[meta[0]]
            for dtype, nplanes, dfpair in ADJ_FORMATS:
                for nets in (N, 1):
                    mk = rand_mask((nets,) + mshape, bits)
                    planes = _adj_planes(rng, (nets, m // 128, 128), dtype, nplanes,
                                         dfpair)
                    got, lay = _call_pass_t(getattr(rd, name_t), meta, planes, mk, bl,
                                            layout, dfpair)
                    torch.cuda.synchronize()
                    want, lay_p = _call_pass_t(getattr(rd, name_tp), meta, planes, mk,
                                               bl, layout, dfpair)
                    if lay != lay_p or not all(
                            _bits_equal(g, w) for g, w in zip(got, want)):
                        raise AssertionError(
                            f"small: {name_t} != {name_tp} ({meta[:2]}, layout {layout}, "
                            f"{dtype.__name__} x{nplanes} dfpair={dfpair}, N={nets})")
                    adj_checks += 1

    ncol = 3000
    idx = rng.integers(0, ncol, size=(N, m))
    for b in range(N):  # one column wanted by ~1500 slots: runs beyond bl
        idx[b, rng.choice(m, size=1500, replace=False)] = 5 + b
    net = rn.build_gather_network(idx, ncol, m, drop_empty=False)
    kinds_seen = set()
    for gmax in (1, 2, 3):
        per_net = [rd.compile_hier(net.kinds, net.dists, net.masks[:, b, :], bl,
                                   gmax=gmax) for b in range(N)]
        metas = tuple(p[:-1] for p in per_net[0])
        if any(tuple(p[:-1] for p in pn) != metas for pn in per_net):
            raise AssertionError("nets of one network differ in pass schedule")
        kinds_seen |= {mt[0] for mt in metas}
        stacked = tuple(
            torch.as_tensor(np.stack([pn[j][-1] for pn in per_net]), device=DEVICE)
            for j in range(len(metas)))
        for dtype, nplanes in FORMATS:
            xs, planes = _planes_for(rng, m, dtype, nplanes)
            _walk_schedule(rd, planes, metas, stacked, bl, True, f"small g={gmax}")
            outs = rd.hier_apply_batched(planes, metas, stacked, bl)
            passes0 = [mt + (mk[0].contiguous(),) for mt, mk in zip(metas, stacked)]
            _walk_schedule(rd, planes, metas, [p[-1] for p in passes0], bl, False,
                           f"small g={gmax} N=1")
            outs0 = rd.hier_apply(planes, passes0, bl)
            torch.cuda.synchronize()
            for x, o, o0 in zip(xs, outs, outs0):
                host = net.apply_host(np.broadcast_to(x.reshape(m), (N, m)))
                got = o.cpu().numpy().reshape(N, m)
                if not (np.array_equal(got, host)
                        and np.array_equal(got, x.reshape(m)[idx])):
                    raise AssertionError(
                        f"small g={gmax}: hier_apply_batched != apply_host")
                if not np.array_equal(o0.cpu().numpy().reshape(m), host[0]):
                    raise AssertionError(f"small g={gmax}: hier_apply != apply_host")
            checks += 1
        # the same schedules in reverse: every adjoint pass against its plain
        # version, the whole sweep against the transpose of x[idx]
        flat = _net_offsets(torch.as_tensor(idx, device=DEVICE))
        for dtype, nplanes, dfpair in ADJ_FORMATS:
            us = _adj_planes(rng, (N, m // 128, 128), dtype, nplanes, dfpair)
            _walk_schedule_t(rd, us, metas, stacked, bl, dfpair, f"small g={gmax} adjoint")
            outs = rd.hier_apply_batched_t(us, metas, stacked, bl, dfpair=dfpair)
            tol = 1e-5 if dtype is np.float32 and not dfpair else 1e-12
            for o, u in zip(_numbers(outs, dfpair), _numbers(us, dfpair)):
                _check_transpose(o, flat, u, tol, f"small g={gmax} hier_apply_batched_t")
            # one net through the same kernels (N = 1)
            one = tuple(u[:1].contiguous() for u in us)
            outs1 = rd.hier_apply_batched_t(
                one, metas, tuple(mk[:1].contiguous() for mk in stacked), bl,
                dfpair=dfpair)
            if not all(_bits_equal(o1[0], o[0]) for o1, o in zip(outs1, outs)):
                raise AssertionError(f"small g={gmax}: adjoint at N = 1 != net 0 of N = 3")
            adj_checks += 1
    if kinds_seen != set(PASS_FNS):
        raise AssertionError(f"small schedules lack a pass kind: {kinds_seen}")
    line = {"phase": "hier_small", "bl": bl, "m": m, "nets": N,
            "random_mask_checks": checks, "adjoint_checks": adj_checks,
            "gmax": [1, 2, 3],
            "formats": ["float32 x1", "float32 x2", "float64 x1"],
            "adjoint_formats": ["float32 x1", "float32 x2", "float32 x2 df",
                                "float64 x1"]}
    emit(line)
    return line


def _inner_order(kind: str, L: int, rng) -> tuple:
    """Stage distances of an inner pass: the Benes inner pass (3 runs), one
    bit (1 run), every bit in turn (a run every rb + 5 stages where the block
    has warp bits) or a random order of 1 to 64 stages."""
    if kind == "benes":
        return tuple([1 << k for k in range(L - 1, -1, -1)] + [1 << k for k in range(1, L)])
    if kind == "one_bit":
        return (1 << (L - 1),) * 9
    if kind == "zigzag":
        return tuple(1 << (3 * j % L) for j in range(min(64, 4 * L)))
    return tuple(int(1 << b) for b in rng.integers(0, L, size=int(rng.integers(1, 65))))


def _inner_planes(rng, dtype, nplanes: int, shape) -> tuple:
    """Random planes with signed zeros and NaNs of many payloads."""
    n = int(np.prod(shape))
    out = []
    for _ in range(nplanes):
        v = rng.standard_normal(n).astype(dtype)
        v[rng.random(n) < 0.02] = -0.0
        ints = v.view(np.int32 if dtype == np.float32 else np.int64)
        nan = rng.random(n) < 0.01
        base = 0x7FC00000 if dtype == np.float32 else 0x7FF8000000000000
        ints[nan] = base + rng.integers(1, 1 << 20, size=int(nan.sum()))
        out.append(torch.as_tensor(v.reshape(shape), device=DEVICE))
    return tuple(out)


INNER_FORMATS = (("float32 x1", np.float32, 1), ("float32 x2", np.float32, 2),
                 ("float64 x1", np.float64, 1), ("float64 x2", np.float64, 2))


def _inner_checks(rd) -> tuple:
    """K3, K3u and K7 at m = 2^16 on forced schedules, bit for bit (int
    view) against the plain versions: bl from 256 to the default, Benes,
    one-bit, zigzag and random stage orders (1, 3 and many runs), random
    masks, N = 1 and 16, shared and per-net input, identity and scrambled
    layouts, every word format, forwards and reversed; a few at forced
    register bits. Returns (checks, run counts seen)."""
    rng = np.random.default_rng(31)
    m = 1 << 16
    bl_max = rd.default_hier_bl(rd.smem_optin_bytes(DEVICE))
    checks, runs_seen = 0, set()
    bl = 256
    while bl <= bl_max:
        L, nb = bl.bit_length() - 1, m // bl
        for oi, order in enumerate(("benes", "one_bit", "zigzag", "random", "random")):
            dists = _inner_order(order, L, rng)
            kinds = ("xor",) * len(dists)
            P = (len(dists) + 7) // 8
            runs_seen.add(len(rd.inner_runs(dists, bl)))
            for fi, (fmt, dtype, nplanes) in enumerate(INNER_FORMATS):
                for reverse in (False, True):
                    j = oi + fi + int(reverse)
                    N = (1, 16)[j % 2]
                    per_net = reverse or (j // 2) % 2 == 1
                    lay = (tuple(int(v) for v in rng.permutation(nb.bit_length() - 1))
                           if j % 3 else None)
                    one_net = N == 1 and not per_net  # the un-batched K3u
                    mk = torch.as_tensor(rng.integers(
                        0, 256, size=(() if one_net else (N,)) + (nb, P, bl // 128, 128),
                        dtype=np.uint8).view(np.int8), device=DEVICE)
                    xs = _inner_planes(rng, dtype, nplanes,
                                       ((N,) if per_net else ()) + (m // 128, 128))
                    if reverse:
                        got = rd.routed_apply_sliced_bt(xs, mk, kinds, dists, layout=lay)
                        want = rd.routed_apply_sliced_bt_plain(xs, mk, kinds, dists,
                                                               layout=lay)
                    else:
                        fn = rd.routed_apply_sliced if one_net else rd.routed_apply_sliced_b
                        got = fn(xs, mk, kinds, dists, layout=lay)
                        want = rd.routed_apply_sliced_plain(xs, mk, kinds, dists, layout=lay)
                    torch.cuda.synchronize()
                    if not all(_bits_equal(g, w) for g, w in zip(got, want)):
                        raise AssertionError(
                            f"inner: bl={bl} {order} {fmt} N={N} per_net={per_net} "
                            f"layout={lay} reverse={reverse}: kernel != plain")
                    checks += 1
                    if bl == 1024 and fi == 1 and order != "one_bit":
                        for rb in (2, 3):  # more threads, fewer registers each
                            got = rd._inner(xs, mk, kinds, dists, lay, not one_net,
                                            reverse, reg_bits=rb)
                            torch.cuda.synchronize()
                            if not all(_bits_equal(g, w) for g, w in zip(got, want)):
                                raise AssertionError(
                                    f"inner: rb={rb} bl={bl} {order}: kernel != plain")
                            checks += 1
        bl *= 2
    return checks, sorted(runs_seen)


def _inner_case(rd, N: int, m: int, bl: int, per_net: bool, reverse: bool, rng):
    """One inner pass at a main path's shapes: random masks, the Benes pass
    (25 stages at bl = 2^13), a df64 pair, a scrambled layout. Returns the
    case as a dict, with `run` (the wrapper) and `plain` on its planes."""
    L, nb = bl.bit_length() - 1, m // bl
    dists = _inner_order("benes", L, rng)
    kinds = ("xor",) * len(dists)
    P = (len(dists) + 7) // 8
    lay = tuple(int(v) for v in rng.permutation(nb.bit_length() - 1))
    mk = torch.as_tensor(rng.integers(0, 256, size=(N, nb, P, bl // 128, 128),
                                      dtype=np.uint8).view(np.int8), device=DEVICE)
    xh = torch.as_tensor(rng.standard_normal(((N,) if per_net else ()) + (m // 128, 128))
                         .astype(np.float32), device=DEVICE)
    planes = (xh, (xh * 2.0 ** -25).contiguous())
    net_axis = N > 1 or reverse
    mkc = mk if net_axis else mk[0]
    if reverse:
        fn, plain = rd.routed_apply_sliced_bt, rd.routed_apply_sliced_bt_plain
    else:
        fn = rd.routed_apply_sliced_b if net_axis else rd.routed_apply_sliced
        plain = rd.routed_apply_sliced_plain
    return {"planes": planes, "mk": mk, "dists": dists, "lay": lay, "nb": nb,
            "run": lambda ps: fn(ps, mkc, kinds, dists, layout=lay),
            "plain": lambda ps: plain(ps, mkc, kinds, dists, layout=lay)}


def _inner_timing(rd, name: str, N: int, m: int, bl: int, per_net: bool, reverse: bool,
                  rng) -> dict:
    """One inner kernel on _inner_case: ms, the plain version, x[idx] on
    the composed index, and the launch configuration."""
    c = _inner_case(rd, N, m, bl, per_net, reverse, rng)
    planes, run = c["planes"], c["run"]
    got = run(planes)
    if not all(_bits_equal(g, w) for g, w in zip(got, c["plain"](planes))):
        raise AssertionError(f"inner timing: {name} != plain")
    nbytes = (sum(p.numel() for p in planes) * 4 + c["mk"].numel() + N * m * 4 * 2)
    return {"name": name, "N": N, "m": m, "bl": bl, "stages": len(c["dists"]),
            "input": "per net" if per_net else "shared",
            "ms": time_ms(lambda: run(planes), 20),
            "plain_ms": time_ms(lambda: c["plain"](planes), 2),
            "library_ms": _composed_gather_ms(run, planes, got, f"inner timing {name}", 20),
            "bound_ms": nbytes / PEAK_BYTES_S * 1e3, "bytes": nbytes,
            "launch": rd.inner_launch_config(2, 4, bl, c["dists"], N=N, nblocks=c["nb"])}


def phase_inner_diag() -> dict:
    """Where K3's time goes at class D's shapes (opt-in, `inner_diag`; not
    part of the whole run): the kept schedule (16 slots a thread), 8 slots
    a thread, the same launch with no stage (the block in and out through
    shared memory) and with 25 stages on one register bit (no shuffle; 2
    runs of at most 16 stages)."""
    from lilac_tpu_torch.kernels import routed as rd

    bl = rd.default_hier_bl(rd.smem_optin_bytes(DEVICE))
    c = _inner_case(rd, 16, 1 << 21, bl, True, False, np.random.default_rng(37))
    planes, mk, lay = c["planes"], c["mk"], c["lay"]
    want = c["plain"](planes)

    def inner(dists, mks, rb=None):
        return rd._inner(planes, mks, ("xor",) * len(dists), dists, lay, True,
                         reg_bits=rb)

    ms = {}
    for rb in (4, 3):
        if not all(_bits_equal(g, w) for g, w in zip(inner(c["dists"], mk, rb), want)):
            raise AssertionError(f"inner_diag: rb={rb} != plain")
        ms[f"benes_{1 << rb}_slots_a_thread"] = time_ms(
            lambda: inner(c["dists"], mk, rb), 20)
    for what, ds in (("no_stage", ()), ("one_register_bit_x25", (1,) * 25)):
        mk_b = mk[:, :, :(len(ds) + 7) // 8].contiguous()
        ms[what] = time_ms(lambda: inner(ds, mk_b), 20)
    line = {"phase": "inner_diag", "kernel": "routed_apply_sliced_b", "N": 16,
            "m": 1 << 21, "bl": bl, "ms": ms}
    emit(line)
    return line


def phase_inner() -> dict:
    """The inner pass (K3, K3u, K7; csrc/inner_pass.cuh) on its own: the
    bit-for-bit checks of _inner_checks, then the three kernels timed at
    the main paths' shapes (class D: N = 16, m = 2^21; the general matrix's
    K3u: N = 1, m = 2^19) beside x[idx]. The earlier design's times stay in
    PERF.md's kernel table, which names the runs that measured them."""
    from lilac_tpu_torch.kernels import routed as rd

    t0 = time.time()
    checks, runs_seen = _inner_checks(rd)
    check_s = time.time() - t0
    rng = np.random.default_rng(37)
    bl = rd.default_hier_bl(rd.smem_optin_bytes(DEVICE))
    timing = [
        _inner_timing(rd, "routed_apply_sliced_b", 16, 1 << 21, bl, True, False, rng),
        _inner_timing(rd, "routed_apply_sliced_bt", 16, 1 << 21, bl, True, True, rng),
        _inner_timing(rd, "routed_apply_sliced", 1, 1 << 19, bl, False, False, rng),
    ]
    torch.cuda.empty_cache()
    line = {"phase": "inner", "checks": checks, "runs_per_pass_seen": runs_seen,
            "check_s": round(check_s, 1), "formats": [f[0] for f in INNER_FORMATS],
            "timing": timing}
    emit(line)
    return line


def _window_dists(bl: int) -> list:
    """Shift sets of the window checks: one shift of 1, NPB's (1, 2, 4, 8),
    the general matrix's eight (1 .. 128; bl >= 256), one shift of bl - 1 (a window across the whole left block) and eight shifts
    that sum to bl - 1."""
    top = [bl >> j for j in range(1, 8)]
    general = tuple(1 << j for j in range(8))
    return [(1,), (1, 2, 4, 8), general, (bl - 1,), tuple(top + [bl - 1 - sum(top)])]


def phase_window() -> dict:
    """K5 and K5u (window_shift_apply_b / window_shift_apply) at m = 2^16,
    bit for bit (int view) against window_shift_apply_plain at every span
    the kernel takes (128 to min(bl, 4096) output slots a thread block): bl
    256, 1024 and the default, the shift sets of _window_dists (sum(d) up to
    bl - 1), random masks (so block 0 reaches into block nblocks - 1),
    identity and scrambled layouts, N = 1 and 16, shared and per-net input,
    every word format, NaN payloads and signed zeros. Then K9 the same way
    (_window_bt_checks)."""
    from lilac_tpu_torch.kernels import routed as rd

    rng = np.random.default_rng(41)
    m = 1 << 16
    checks = 0
    t0 = time.time()
    for bl in sorted({256, 1024, rd.default_hier_bl(rd.smem_optin_bytes(DEVICE))}):
        nb = m // bl
        for span in _window_spans(bl):
            for dists in _window_dists(bl):
                for N in (1, 16):
                    j = checks
                    dtype, nplanes = FORMATS[j % len(FORMATS)]
                    per_net = (j // 2) % 2 == 1
                    lay = (tuple(int(v) for v in rng.permutation(nb.bit_length() - 1))
                           if j % 3 else None)
                    one_net = N == 1 and not per_net  # the un-batched K5u
                    mk = torch.as_tensor(rng.integers(
                        0, 256, size=(() if one_net else (N,)) + (nb, 2 * bl // 128, 128),
                        dtype=np.uint8).view(np.int8), device=DEVICE)
                    xs = _inner_planes(rng, dtype, nplanes,
                                       ((N,) if per_net else ()) + (m // 128, 128))
                    fn = rd.window_shift_apply if one_net else rd.window_shift_apply_b
                    got = fn(xs, mk, dists, bl, layout=lay, span=span)
                    want = rd.window_shift_apply_plain(xs, mk, dists, bl, layout=lay)
                    torch.cuda.synchronize()
                    if not all(_bits_equal(g, w) for g, w in zip(got, want)):
                        raise AssertionError(
                            f"window: bl={bl} span={span} dists={dists} N={N} "
                            f"{dtype.__name__} x{nplanes} per_net={per_net} layout={lay}: "
                            "kernel != plain")
                    checks += 1
    checks_bt = _window_bt_checks(rd, rng, m)
    line = {"phase": "window", "m": m, "checks": checks, "checks_bt": checks_bt,
            "check_s": round(time.time() - t0, 1),
            "formats": ["float32 x1", "float32 x2", "float64 x1"],
            "formats_bt": ["float32 x1", "float32 x2", "float32 df64 pair", "float64 x1"]}
    emit(line)
    return line


F64_NAN = float(np.array(0x7FF80000000BEEF5, dtype=np.int64).view(np.float64))


def _window_bt_dists(bl: int) -> list:
    """Shift sets of the adjoint window checks: class D's (8, 4, 2, 1), the
    general matrix's eight (1 .. 128), one shift of bl - 1 and eight shifts
    that sum to bl - 1."""
    top = [bl >> j for j in range(1, 8)]
    return [(8, 4, 2, 1), tuple(1 << j for j in range(8)), (bl - 1,),
            tuple(top + [bl - 1 - sum(top)])]


def _network_windows(m: int, bl: int, N: int, seed: int) -> list:
    """The window passes compile_hier cuts from N Benes gather networks over
    m slots (a sixteenth of each net's slots ask for one column, so that
    broadcast runs cross blocks): [(dists, masks [N, nblocks, 2R, 128])]."""
    from lilac_tpu_torch.kernels import routed as rd
    from lilac_tpu_torch.kernels import routenet as rn

    rng = np.random.default_rng(seed)
    idx = rng.integers(0, m - 100, size=(N, m))
    for n in range(N):
        idx[n, rng.choice(m, size=m // 16, replace=False)] = 5 + n
    net = rn.build_gather_network(idx, m - 100, m, drop_empty=False)
    per_net = [rd.compile_hier(net.kinds, net.dists, net.masks[:, n, :], bl)
               for n in range(N)]
    return [(p[1], torch.as_tensor(np.stack([per_net[n][j][-1] for n in range(N)]),
                                   device=DEVICE))
            for j, p in enumerate(per_net[0]) if p[0] == "window"]


def _window_bt_checks(rd, rng, m: int) -> int:
    """K9 (window_shift_apply_bt) bit for bit (int view) against
    window_shift_apply_bt_plain at every span it takes (128 to bl output
    slots a thread block): bl 256, 1024 and the default, the shift sets of
    _window_bt_dists with random masks (so the last block wraps to block 0)
    and the window passes of gather networks, identity and scrambled
    layouts, N = 1 and 16, every word format (f32, f32 x2, an f32 df64
    pair, f64), NaN payloads and signed zeros in the input. The f64 planes
    hold NaNs of one payload: where two NaNs of different payloads meet in
    an f64 add, the H100 keeps one payload and PyTorch's add (a + alpha * b,
    an FMA on the card) may keep the other. IEEE 754 leaves that choice
    open, and nvcc may swap an add's operands, so no operand order fixes
    it. An f32 NaN sum on the card is the canonical NaN either way."""
    checks = 0
    limit = rd.smem_optin_bytes(DEVICE)
    for bl in sorted({256, 1024, rd.default_hier_bl(limit)}):
        nb = m // bl
        cases = [(dists, N, None) for dists in _window_bt_dists(bl) for N in (1, 16)]
        cases += [(dists, mk.shape[0], mk) for dists, mk in _network_windows(m, bl, 2, bl)]
        for span in (1 << j for j in range(7, 14)):
            if span > bl:
                break
            for dists, N, mk in cases:
                dtype, nplanes, dfpair = ADJ_FORMATS[checks % len(ADJ_FORMATS)]
                esize = np.dtype(dtype).itemsize
                if rd.window_bt_smem_bytes(span, dists, nplanes, esize) > limit:
                    continue  # the wrapper refuses a span that does not fit
                lay = (tuple(int(v) for v in rng.permutation(nb.bit_length() - 1))
                       if checks % 3 else None)
                if mk is None:
                    mk = torch.as_tensor(rng.integers(
                        0, 256, size=(N, nb, 2 * bl // 128, 128),
                        dtype=np.uint8).view(np.int8), device=DEVICE)
                xs = _inner_planes(rng, dtype, nplanes, (N, m // 128, 128))
                if dtype == np.float64:  # see the docstring: one NaN payload
                    for x in xs:
                        x[torch.isnan(x)] = F64_NAN
                got = rd.window_shift_apply_bt(xs, mk, dists, bl, dfpair=dfpair,
                                               layout=lay, span=span)
                want = rd.window_shift_apply_bt_plain(xs, mk, dists, bl, dfpair=dfpair,
                                                      layout=lay)
                torch.cuda.synchronize()
                if not all(_bits_equal(g, w) for g, w in zip(got, want)):
                    raise AssertionError(
                        f"window_bt: bl={bl} span={span} dists={dists} N={N} "
                        f"{dtype.__name__} x{nplanes} dfpair={dfpair} layout={lay}: "
                        f"kernel != plain: {_bits_diff(got, want)}")
                checks += 1
    return checks


def phase_window_diag() -> dict:
    """K5 and K5u at every span (output slots a thread block) the kernel
    takes, at the main paths' shapes with random masks (opt-in,
    `window_diag`; not part of the whole run): K5 at class D's (N = 16, m =
    2^21, shifts 1, 2, 4, 8, input per net, scrambled layout), K5u at the
    general matrix's (m = 2^19, shifts 1 .. 128), df64 pairs. Each span is
    held bit for bit against the plain version before it is timed."""
    from lilac_tpu_torch.kernels import routed as rd

    rng = np.random.default_rng(43)
    bl = rd.default_hier_bl(rd.smem_optin_bytes(DEVICE))
    rows = []
    for name, N, m, dists in (("window_shift_apply_b", 16, 1 << 21, (1, 2, 4, 8)),
                              ("window_shift_apply", 1, 1 << 19,
                               tuple(1 << j for j in range(8)))):
        nb = m // bl
        lay = tuple(int(v) for v in rng.permutation(nb.bit_length() - 1)) if N > 1 else None
        mk = torch.as_tensor(rng.integers(
            0, 256, size=((N,) if N > 1 else ()) + (nb, 2 * bl // 128, 128),
            dtype=np.uint8).view(np.int8), device=DEVICE)
        xs = _inner_planes(rng, np.float32, 2, ((N,) if N > 1 else ()) + (m // 128, 128))
        fn = getattr(rd, name)
        want = rd.window_shift_apply_plain(xs, mk, dists, bl, layout=lay)
        ms = {}
        for span in _window_spans(bl):
            got = fn(xs, mk, dists, bl, layout=lay, span=span)
            if not all(_bits_equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"window_diag: {name} span={span} != plain")
            ms[str(span)] = time_ms(lambda: fn(xs, mk, dists, bl, layout=lay, span=span), 20)
        rows.append({"kernel": name, "N": N, "m": m, "bl": bl, "dists": list(dists),
                     "default_span": rd.window_span(bl), "ms_by_span": ms})
        del xs, mk, want
    torch.cuda.empty_cache()
    line = {"phase": "window_diag", "rows": rows}
    emit(line)
    return line


def phase_window_bt_diag() -> dict:
    """K9 (window_shift_apply_bt) at every span (output slots a thread
    block) it takes, at the main paths' shapes with random masks (opt-in,
    `window_bt_diag`; not part of the whole run): class D's (N = 16, m =
    2^21, shifts 8, 4, 2, 1, scrambled layout) and the general matrix's (N =
    6, m = 2^19, shifts 1 .. 128), df64 pairs. Each span is held bit for bit
    against the plain version before it is timed."""
    from lilac_tpu_torch.kernels import routed as rd

    rng = np.random.default_rng(47)
    bl = rd.default_hier_bl(rd.smem_optin_bytes(DEVICE))
    rows = []
    for what, N, m, dists in (("class D", 16, 1 << 21, (8, 4, 2, 1)),
                              ("general matrix", 6, 1 << 19,
                               tuple(1 << j for j in range(8)))):
        nb = m // bl
        lay = tuple(int(v) for v in rng.permutation(nb.bit_length() - 1))
        mk = torch.as_tensor(rng.integers(0, 256, size=(N, nb, 2 * bl // 128, 128),
                                          dtype=np.uint8).view(np.int8), device=DEVICE)
        us = _adj_planes(rng, (N, m // 128, 128), np.float32, 2, True)
        want = rd.window_shift_apply_bt_plain(us, mk, dists, bl, dfpair=True, layout=lay)
        def timed(span, shifts=dists):
            got = rd.window_shift_apply_bt(us, mk, shifts, bl, dfpair=True, layout=lay,
                                           span=span)
            if shifts == dists and not all(_bits_equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"window_bt_diag: {what} span={span} "
                                     f"spans={rd.WINDOW_BT_SPANS} != plain")
            return time_ms(lambda: rd.window_shift_apply_bt(
                us, mk, shifts, bl, dfpair=True, layout=lay, span=span), 20)

        ms = {str(span): timed(span) for span in (1 << j for j in range(7, 14))
              if span <= bl}
        # spans a thread block takes in turn, at the default span; and the
        # same thread blocks with no stage: staging and storing alone
        span0 = rd.window_bt_span(bl, dists, 2, 4)
        default_spans = rd.WINDOW_BT_SPANS
        by_spans = {}
        try:
            for spans in (1, 4, 16, 64):
                rd.WINDOW_BT_SPANS = spans
                by_spans[str(spans)] = timed(span0)
        finally:
            rd.WINDOW_BT_SPANS = default_spans
        no_stage = {str(span): timed(span, ()) for span in (128, 1024) if span <= bl}
        nbytes = 2 * N * m * 4 * 2 + mk.numel() // 2
        rows.append({"shape": what, "N": N, "m": m, "bl": bl, "dists": list(dists),
                     "default_span": span0, "default_spans_per_block": default_spans,
                     "bound_ms": nbytes / PEAK_BYTES_S * 1e3, "ms_by_span": ms,
                     "ms_by_spans_per_block": by_spans, "no_stage_ms_by_span": no_stage})
        del us, mk, want
    torch.cuda.empty_cache()
    line = {"phase": "window_bt_diag", "rows": rows}
    emit(line)
    return line


def _general_matrix(rng, n: int) -> tuple:
    """The general n x n matrix of phase_hier_general as host CSR (indptr,
    indices, data): 1 to 11 entries a row, columns unsorted and possibly
    repeated, column 7 in a quarter of the rows (its broadcast run needs
    block-aligned shifts)."""
    counts = rng.integers(1, 12, size=n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    indices = rng.integers(0, n, size=int(indptr[-1]))
    dense_rows = rng.choice(n, size=n // 4, replace=False)
    indices[indptr[dense_rows]] = 7  # column 7 stands in a quarter of the rows
    data = rng.standard_normal(len(indices))
    return indptr, indices, data


EXCHANGE_SHAPES = ((4, 256), (4, 64), (4, 32), (2, 128), (2, 64), (1, 128), (1, 64))


def _bigshift_net(M):
    """A device copy of the first net of host-staged hier plan M whose
    schedule holds a block-aligned shift: the net that the un-batched
    kernels K3u-K6u (rs.hier_net_apply) are held and timed on."""
    from lilac_tpu_torch.kernels import routed_spmv as rs

    i = next(i for i, g in enumerate(M.nets)
             if any(mt[0] == "bigshift" for mt in g.pass_meta))
    return rs._net_to_device(M.nets[i], DEVICE), i


def phase_exchange_diag() -> dict:
    """K4u and K6u on one net of the general matrix's plan (opt-in,
    `exchange_diag`; not in the whole run): the first butterfly pass and
    the first block-aligned shift of the net's schedule, with L2 flushed and
    back to back, beside a flushed copy_ of the same bytes, at the default
    launch shape and at every (slots, threads) of EXCHANGE_SHAPES, each
    held bit for bit against the plain version. (4, 256) is the shape K4u
    launched before butterfly_launch_config. Run beside an older tree of
    the package, whose wrappers take no `launch`, it times the default
    shape alone."""
    import inspect

    from lilac_tpu_torch.kernels import routed as rd
    from lilac_tpu_torch.kernels import routed_spmv as rs
    from lilac_tpu_torch.ops import dfloat as df

    rng = np.random.default_rng(23)
    n = 400_000
    indptr, indices, data = _general_matrix(rng, n)
    x = rng.standard_normal(n)
    M = rs.build_routed_csr_hier(indptr, indices, data, (n, n), dtype="df64")
    net, _ = _bigshift_net(M)
    xh, xl = df.from_f64(x, device=DEVICE)
    planes = (_plane(xh, M.m), _plane(xl, M.m))
    shapes = [None]
    if "launch" in inspect.signature(rd.butterfly_apply).parameters:
        shapes += list(EXCHANGE_SHAPES)
    line = {"phase": "exchange_diag", "m": M.m, "bl": M.bl, "passes": {}}
    layout = None
    for meta, mk in zip(net.pass_meta, net.pass_masks):
        kind = meta[0]
        fn = getattr(rd, PASS_FNS[kind][1])
        got, new_layout = _call_pass(fn, meta, planes, mk, M.bl, layout)
        if kind in ("butterfly", "bigshift") and kind not in line["passes"]:
            want, _ = _call_pass(getattr(rd, PASS_FNS[kind][2]), meta, planes, mk,
                                 M.bl, layout)
            nbytes = 2 * sum(p.numel() for p in planes) * 4 + mk.numel()
            row = {"pass": [str(v) for v in meta], "bytes": nbytes,
                   "bound_ms": nbytes / PEAK_BYTES_S * 1e3,
                   "copy_ms": _copy_ms(nbytes, 20),
                   "copy_warm_ms": _copy_ms(nbytes, 20, warm=True), "shapes": []}
            for shape in shapes:
                call = fn if shape is None else functools.partial(fn, launch=shape)
                out, _ = _call_pass(call, meta, planes, mk, M.bl, layout)
                if not all(_bits_equal(o, w) for o, w in zip(out, want)):
                    raise AssertionError(f"exchange_diag: {kind} at {shape} != plain")

                def run():
                    return _call_pass(call, meta, planes, mk, M.bl, layout)

                row["shapes"].append({
                    "launch": "default" if shape is None else list(shape),
                    "ms": time_cold_ms(run, 20), "warm_ms": time_ms(run, 20)})
            if hasattr(rd, "butterfly_launch_config"):
                row["default"] = _exchange_launch(rd, meta, planes, 1, M.m, M.bl)
            line["passes"][kind] = row
            del want
        planes, layout = got, new_layout
    emit(line)
    return line


def phase_hier_general(kernels: dict, n: int = 400_000, bl: int | None = None) -> dict:
    """The second driven path: y = A x for a general sparse matrix through
    build_routed_csr_hier at the default block length. Rows come unsorted (so
    the un-permute network runs) and one column is dense enough that its
    broadcast run needs block-aligned shifts. The packed plan (K3-K6) runs
    in df64 and f64 against the f64 CSR product; launch counts are set to 0
    before each run and read after it. The un-batched kernels K3u-K6u are
    held on one net of the plan, a device copy of it through
    rs.hier_net_apply: its output equals the packed group's row for that net
    bit for bit, and every pass equals its plain version. K6 and the four
    un-batched kernels are timed here, on this plan's own passes. The
    transpose product A^T u runs through the same plan in reverse (kernels
    K7-K10) against scipy's A^T u, and one net's schedule in reverse at
    N = 1; K10, which no NPB plan reaches, is timed and counted here."""
    import scipy.sparse as sp

    from lilac_tpu_torch.kernels import dfmulred as dfk
    from lilac_tpu_torch.kernels import routed as rd
    from lilac_tpu_torch.kernels import routed_spmv as rs
    from lilac_tpu_torch.ops import dfloat as df

    rng = np.random.default_rng(23)
    ncol = n
    indptr, indices, data = _general_matrix(rng, n)
    # scipy gets copies: abs() below merges duplicate entries in place
    A = sp.csr_matrix((data.copy(), indices.copy(), indptr.copy()), shape=(n, ncol))
    x = rng.standard_normal(ncol)
    want = A @ x
    scale = abs(A) @ np.abs(x)
    u = rng.standard_normal(n)
    want_t = A.T @ u
    scale_t = abs(A).T @ np.abs(u)

    line = {"phase": "hier_general", "n": n, "nnz": int(indptr[-1]), "runs": []}
    timed: dict = {}
    launches: dict = {}  # per kernel, from the df64 runs
    unperm_launches: dict = {}  # K3u-K6u in the df64 product: the un-permute network's
    batched = [PASS_FNS[k][0] for k in PASS_FNS]
    single = [PASS_FNS[k][1] for k in PASS_FNS]
    for dtype, tol in (("df64", 4e-14), ("f64", 1e-13)):
        t0 = time.time()
        M = rs.build_routed_csr_hier(
            indptr, indices, data, (n, ncol), dtype=dtype, bl=bl)
        build_s = time.time() - t0
        if M.unperm is None:
            raise AssertionError("general matrix: rows came sorted, no un-permute")
        net, net_id = _bigshift_net(M)
        P = rs.maybe_pack_hier(M, DEVICE)
        if not isinstance(P, rs.RoutedMatHierP):
            raise AssertionError(f"maybe_pack_hier gave a {type(P).__name__}")
        if dtype == "df64":
            xh, xl = df.from_f64(x, device=DEVICE)
            planes = (_plane(xh, M.m), _plane(xl, M.m))
        else:
            planes = (_plane(torch.as_tensor(x, device=DEVICE), M.m),)
        # one net through the un-batched kernels, against its packed group
        _reset_hier_counts(rd, dfk)
        outs = rs.hier_net_apply(net, planes, M.bl)
        torch.cuda.synchronize()
        counts_net = _hier_counts(rd)
        if any(counts_net[name] <= 0 for name in single) or any(
                counts_net[name] for name in batched):
            raise AssertionError(
                f"general matrix {dtype}: one net's launches {counts_net}")
        grp = next(g for g in P.groups if net_id in g.net_ids)
        outs_g = rd.hier_apply_batched(planes, grp.pass_meta, grp.pass_masks, M.bl)
        li = grp.net_ids.index(net_id)
        if not all(_bits_equal(o.reshape(-1), og[li].reshape(-1))
                   for o, og in zip(outs, outs_g)):
            raise AssertionError(
                f"general matrix {dtype}: net {net_id} through hier_net_apply != "
                "its packed group's row")
        del outs, outs_g
        what = f"general matrix {dtype}, one net"
        _walk_schedule(rd, planes, net.pass_meta, net.pass_masks, M.bl, False, what,
                       timed if dtype == "df64" else None, 10)
        # the same schedule in reverse on one net's cotangents (the adjoint
        # kernels at N = 1)
        _walk_schedule_t(
            rd, _adj_planes(rng, (1, M.m // 128, 128), np.float32, 2, True),
            net.pass_meta, tuple(mk.unsqueeze(0) for mk in net.pass_masks), M.bl,
            True, f"general matrix {dtype}, one net (N = 1)", None, 10)
        if dtype == "df64":
            launches.update({name: counts_net[name] for name in single})
        del net

        _reset_hier_counts(rd, dfk)
        if dtype == "df64":
            got = df.to_f64(rs.routed_hier_spmv_df(P, df.from_f64(x, device=DEVICE)))
        else:
            got = rs.routed_hier_spmv(
                P, torch.as_tensor(x, device=DEVICE)).cpu().numpy()
        torch.cuda.synchronize()
        counts_run = _hier_counts(rd)
        err = float((np.abs(got - want) / scale).max())
        line["runs"].append({
            "dtype": dtype, "build_s": round(build_s, 2),
            "m": M.m, "m_out": M.m_out, "bl": M.bl, "nets": len(M.nets),
            "groups": len(P.groups),
            "max_err_over_sum_abs": err, "tol": tol, "launches": counts_run,
            "dfmulred_launches": dfk.dfmulred.launches,
            "one_net": {"net": net_id, "passes": len(grp.pass_meta),
                        "launches": {k: counts_net[k] for k in single}}})
        if got.shape != (n,) or not np.isfinite(got).all() or err > tol:
            raise AssertionError(f"general matrix {dtype}: {err}")
        for name in batched:
            if counts_run[name] <= 0:
                raise AssertionError(f"general matrix {dtype}: {name} not launched")
        # the transpose product through the same plan in reverse
        _reset_hier_counts(rd, dfk)
        if dtype == "df64":
            got_t = df.to_f64(
                rs.routed_hier_spmv_adj_t_df(P, df.from_f64(u, device=DEVICE)))
        else:
            got_t = rs.routed_hier_spmv_adj_t(
                P, torch.as_tensor(u, device=DEVICE)).cpu().numpy()
        torch.cuda.synchronize()
        counts_t = _hier_counts(rd)
        # columns no row touches have scale 0 and must come out exactly 0
        err_t = float((np.abs(got_t - want_t) / np.maximum(scale_t, 1e-300)).max())
        line["runs"][-1].update(
            adjoint_max_err_over_sum_abs=err_t,
            adjoint_launches={k: counts_t[k] for k in ADJ_NAMES})
        if got_t.shape != (ncol,) or not np.isfinite(got_t).all() or err_t > tol:
            raise AssertionError(f"general matrix {dtype}: adjoint error {err_t}")
        if any(counts_t[name] <= 0 for name in ADJ_NAMES) or any(
                counts_t[name] for name in batched + single):
            raise AssertionError(
                f"general matrix {dtype}: adjoint launches {counts_t}")
        if dtype == "df64":
            launches.update({name: counts_t[name] for name in ADJ_NAMES})
            launches.update({name: counts_run[name] for name in batched})
            unperm_launches.update({name: counts_run[name] for name in single})
            # time on this plan's own passes, on the first packed group whose
            # schedule holds a block-aligned shift, forwards and in reverse
            g = next(g for g in P.groups
                     if any(mt[0] == "bigshift" for mt in g.pass_meta))
            _walk_schedule(rd, planes, g.pass_meta, g.pass_masks, M.bl, True,
                           "general matrix, packed group", timed, 10)
            _walk_schedule_t(
                rd, _adj_planes(rng, (g.pass_masks[0].shape[0], M.m // 128, 128),
                                np.float32, 2, True),
                g.pass_meta, g.pass_masks, M.bl, True, "general matrix, packed group",
                timed, 10)
        del P, M, planes
        torch.cuda.empty_cache()
    for name in single + ["bigshift_apply_b"] + ADJ_NAMES:
        if name not in timed:
            raise AssertionError(f"general matrix: no {name} pass to time")
        kernels[name] = timed[name]
        kernels[name]["launches"] = launches[name]
        kernels[name]["launches_on"] = "general-matrix hier SpMV (df64)" + (
            ", transpose product" if name in ADJ_NAMES else "")
        if name in single:
            kernels[name]["launches_on"] = (
                "one net of the general-matrix hier plan (df64) through hier_net_apply")
            kernels[name]["launches_unperm"] = unperm_launches[name]
    line["general_launches"] = launches
    line["unperm_launches"] = unperm_launches
    emit(line)
    return line


SEG_SIZE_GENERAL = 1 << 18  # two segments of the 400 000-column matrix
# a product against the gather plan's, over sum |a x| a row: f32 sums of up
# to 11 terms and a segment add in another order; df64 as the other layouts
SEG_TOL = {"f32": 1e-5, "df64": 4e-14}


def _k1_segment(rd, M, s: int, rng, kernels_row: dict | None) -> dict:
    """K1 on segment s's own tables: one random plane per word of the plan,
    bit for bit against routed_apply_plain; with `kernels_row`, timed beside
    its byte bound and x[idx] on the index the segment's networks compose."""
    m, masks, kinds, dists = M.m, M.masks[s], M.kinds[s], M.dists[s]
    B, P = masks.shape[0], masks.shape[1]
    nplanes = 2 if M.vals[s].dim() == 3 else 1
    planes = [_f32_plane(rng, m, m) for _ in range(nplanes)]
    got = rd.routed_apply(planes, masks, kinds, dists)
    torch.cuda.synchronize()
    want = rd.routed_apply_plain(planes, masks, kinds, dists)
    if not all(_bits_equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"segment {s}: routed_apply != routed_apply_plain "
                             f"{_bits_diff(got, want)}")
    out = {"segment": s, "m": m, "nets": B, "stages": len(kinds), "planes": nplanes,
           "bit_identical_to_plain": True}
    if kernels_row is None:
        return out
    iota = torch.arange(m, dtype=torch.float32, device=DEVICE).view(m // 128, 128)
    (routed_iota,) = rd.routed_apply([iota], masks, kinds, dists)
    gidx = routed_iota.view(B, m).to(torch.int64)
    flat = [p.view(m) for p in planes]
    if not all(torch.equal(o.view(B, m), f[gidx]) for o, f in zip(got, flat)):
        raise AssertionError(f"segment {s}: the network differs from its composed gather")
    nbytes = nplanes * m * 4 + B * P * m + nplanes * B * m * 4
    out.update(
        ms=time_ms(lambda: rd.routed_apply(planes, masks, kinds, dists), 20),
        plain_ms=time_ms(lambda: rd.routed_apply_plain(planes, masks, kinds, dists), 2),
        bound_ms=nbytes / PEAK_BYTES_S * 1e3, bytes=nbytes,
        library_ms=time_ms(lambda: [f[gidx] for f in flat], 20))
    kernels_row.setdefault("seg_general", []).append(
        {k: out[k] for k in ("segment", "m", "nets", "stages", "planes", "ms",
                             "plain_ms", "bound_ms", "bytes", "library_ms")})
    return out


def phase_seg_general(kernels: dict, n: int = 400_000) -> dict:
    """The general matrix of phase_hier_general (canonical: columns sorted
    within each row) through column-segmented routing, build_routed_csr_seg
    at seg_size 2^18 (two segments), in f32 and df64: every segment's K1
    bit for bit against its plain version on that segment's tables (the
    df64 plan's timed beside its bound and x[idx]), the product (K1 a
    segment, K2 a segment in df64, counts set to 0 before and read after)
    against the gather plan's (xla_sell / xla_sell_df) to SEG_TOL of
    sum |a x| a row, and one save / load round trip of the plan file giving
    the same product bit for bit."""
    import scipy.sparse as sp

    from lilac_tpu_torch.config import cfg
    from lilac_tpu_torch.formats import convert as tconv
    from lilac_tpu_torch.kernels import dfmulred as dfk
    from lilac_tpu_torch.kernels import routed as rd
    from lilac_tpu_torch.kernels import routed_spmv as rs
    from lilac_tpu_torch.ops import dfloat as df
    from lilac_tpu_torch.plan import SpmvPlan
    from lilac_tpu_torch.utils.profiling import tensor_bytes

    t_phase = time.time()
    k1_row = kernels.setdefault("routed_apply", {"name": "routed_apply"})
    k2_row = kernels.setdefault("dfmulred", {"name": "dfmulred"})
    rng = np.random.default_rng(23)
    indptr, indices, data = _general_matrix(rng, n)
    rows = np.repeat(np.arange(n), np.diff(indptr))
    ip, ix, vv = tconv.coo_to_csr_arrays(rows, indices, data, (n, n), sum_duplicates=False)
    A = sp.csr_matrix((vv.copy(), ix.copy(), ip.copy()), shape=(n, n))
    x = rng.standard_normal(n)
    scale = abs(A) @ np.abs(x)
    line = {"phase": "seg_general", "n": n, "nnz": int(ip[-1]),
            "seg_size": SEG_SIZE_GENERAL, "runs": []}
    ddir = cfg().resolved_data_dir()
    os.makedirs(ddir, exist_ok=True)
    for dtype in ("f32", "df64"):
        t0 = time.time()
        M = rs.build_routed_csr_seg(ip, ix, vv, (n, n), dtype=dtype,
                                    seg_size=SEG_SIZE_GENERAL, device=DEVICE)
        build_s = time.time() - t0
        nseg = len(M.masks)
        if nseg != 2:
            raise AssertionError(f"seg plan of {nseg} segments, 2 expected")
        k1_rows = [_k1_segment(rd, M, s, rng, k1_row if dtype == "df64" else None)
                   for s in range(nseg)]
        if dtype == "df64":
            xin = df.from_f64(x, device=DEVICE)

            def product(P):
                return df.to_f64(rs.routed_seg_spmv_df(P, xin))
        else:
            xin = torch.as_tensor(x.astype(np.float32), device=DEVICE)

            def product(P):
                return rs.routed_seg_spmv(P, xin).double().cpu().numpy()
        _reset_hier_counts(rd, dfk)
        got = product(M)
        torch.cuda.synchronize()
        counts = {"routed_apply": rd.routed_apply.launches,
                  "dfmulred": dfk.dfmulred.launches}
        gplan = SpmvPlan(ip, ix, vv, (n, n), dtype=dtype,
                         kernel="xla_sell_df" if dtype == "df64" else "xla_sell",
                         device=DEVICE)
        want = gplan.vec_out(gplan.matvec(gplan.vec_in(x)))
        err = float((np.abs(got - want) / scale).max())
        path = os.path.join(ddir, f"seg_general_{dtype}.npz")
        t0 = time.time()
        rs.save_routed(path, M)
        L = rs.load_routed(path, device=DEVICE)
        io_s = time.time() - t0
        os.remove(path)
        same = np.array_equal(product(L), got)
        run = {"dtype": dtype, "build_s": round(build_s, 2), "segments": nseg,
               "nets": [mk.shape[0] for mk in M.masks],
               "stages": [len(k) for k in M.kinds],
               "bytes_on_card": tensor_bytes(M),
               "k1_segments": k1_rows, "launches": counts,
               "max_err_over_sum_abs_vs_gather": err, "tol": SEG_TOL[dtype],
               "gather_kernel": gplan.kernel,
               "ms": time_ms(lambda: product(M), 5),
               "gather_ms": time_ms(lambda: gplan.matvec(gplan.vec_in(x)), 5),
               "save_load_s": round(io_s, 2), "reloaded_bit_identical": same}
        line["runs"].append(run)
        if got.shape != (n,) or not np.isfinite(got).all() or err > SEG_TOL[dtype] \
                or not same or counts["routed_apply"] != nseg \
                or counts["dfmulred"] != (nseg if dtype == "df64" else 0):
            raise AssertionError(f"seg general {dtype}: {run}")
        k1_row[f"launches_seg_{dtype}"] = counts["routed_apply"]
        if dtype == "df64":
            k2_row["launches_seg_df64"] = counts["dfmulred"]
        del M, L, gplan
        torch.cuda.empty_cache()
    line["wall_s"] = round(time.time() - t_phase, 1)
    emit(line)
    return line


def phase_hier_class_d(plan_d, kernels: dict) -> dict:
    """K3, K4, K5 (and K6 where the plan has such a pass) at class D's own
    shapes: the largest packed group of the V plan, every pass of its
    schedule held bit for bit against the plain version on all its nets, the
    first pass of each kind timed. Then K7, K8, K9 on the same schedule in
    reverse (a df64 pair per net, each pass with the layout the reversed
    sweep meets), the whole reversed schedule against the transpose of the
    gather it encodes, and <G x, u> = <x, G^T u> in f64."""
    from lilac_tpu_torch.kernels import routed as rd

    V = plan_d.A.V
    grp = max(V.groups, key=lambda g: len(g.net_ids))
    rng = np.random.default_rng(29)
    xh = torch.as_tensor(rng.standard_normal(V.shape[1]).astype(np.float32),
                         device=DEVICE)
    xl = (xh * 2.0 ** -25).contiguous()
    planes = (_plane(xh, V.m), _plane(xl, V.m))
    timed: dict = {}
    _walk_schedule(rd, planes, grp.pass_meta, grp.pass_masks, V.bl, True,
                   f"class D V plan, group of {len(grp.net_ids)} nets", timed, 10)
    for name, row in timed.items():
        if name == "bigshift_apply_b" and name in kernels:
            continue  # K6's row stays the general matrix's, where it is launched
        kernels[name] = row
    # the same schedule for one net through the un-batched wrappers
    _walk_schedule(rd, planes, grp.pass_meta,
                   [mk[0].contiguous() for mk in grp.pass_masks], V.bl, False,
                   "class D V plan, one net")
    # the schedule in reverse through the adjoint kernels, a df64 pair per net
    N = len(grp.net_ids)
    timed_t: dict = {}
    us = _adj_planes(rng, (N, V.m // 128, 128), np.float32, 2, True)
    _walk_schedule_t(rd, us, grp.pass_meta, grp.pass_masks, V.bl, True,
                     f"class D V plan, group of {N} nets, reversed", timed_t, 10)
    for name, row in timed_t.items():
        if name == "bigshift_apply_bt" and name in kernels:
            continue  # K10's row stays the general matrix's
        kernels[name] = row
    _walk_schedule_t(rd, tuple(u[:1].contiguous() for u in us), grp.pass_meta,
                     [mk[:1].contiguous() for mk in grp.pass_masks], V.bl, True,
                     "class D V plan, one net (N = 1), reversed")
    # K2 on the group's whole product: every chunk of its nets in one launch
    from lilac_tpu_torch.kernels import dfmulred as dfk
    from lilac_tpu_torch.kernels import routed_spmv as rs

    gi = next(i for i, g in enumerate(V.groups) if g is grp)
    table = rs._hier_k2(V.chunks, tuple(g.net_ids for g in V.groups), V.m)[gi]
    ph = torch.as_tensor(rng.standard_normal(N * V.m).astype(np.float32), device=DEVICE)
    k2_args = (grp.vals[0].reshape(-1), grp.vals[1].reshape(-1), ph,
               (ph * 2.0 ** -26).contiguous(), table)
    got = dfk.dfmulred_chunks(*k2_args)
    want = dfk.dfmulred_chunks_plain(*k2_args)
    if not all(_bits_equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("dfmulred_chunks != plain on class D's group product")
    k2_row = kernels.setdefault("dfmulred", {"name": "dfmulred", "launches": 0})
    k2_row.setdefault("products", {})["class D group"] = _k2_product(
        dfk, k2_args, "class D's group")
    del ph, k2_args, got, want
    # NPB's broadcast runs are short, so its plans hold no block-aligned
    # shift: K6 and K10 meet class D's shapes on a random 0/1 mask instead,
    # planes per net, read through the layout a butterfly pass leaves
    shift_extra = {}
    if not any(mt[0] == "bigshift" for mt in grp.pass_meta):
        R = V.bl // 128
        nblocks = V.m // V.bl
        per_net = tuple(p.unsqueeze(0).expand(N, -1, -1).contiguous() for p in planes)
        meta = ("bigshift", 5 * V.bl)
        lay = tuple(range(3, nblocks.bit_length() - 1)) + (0, 1, 2)
        for name, plain_name, batched in (
                ("bigshift_apply_b", "bigshift_apply_plain", True),
                ("bigshift_apply", "bigshift_apply_plain", False),
                ("bigshift_apply_bt", "bigshift_apply_bt_plain", True)):
            adjoint = name.endswith("_bt")
            mk = torch.as_tensor(
                rng.integers(0, 2, size=((N,) if batched else ())
                             + (nblocks, R, 128), dtype=np.int8), device=DEVICE)
            xs = us if adjoint else per_net if batched else planes

            def run(fn_name):
                if adjoint:
                    return _call_pass_t(getattr(rd, fn_name), meta, xs, mk, V.bl, lay, True)
                return _call_pass(getattr(rd, fn_name), meta, xs, mk, V.bl, lay)

            got, _ = run(name)
            want, _ = run(plain_name)
            if not all(_bits_equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"{name} != plain at class D shapes")
            del got, want
            nets = N if batched else 1
            nbytes = 2 * nets * V.m * 4 * len(planes) + mk.numel()
            shift_extra[name] = {
                "ms": time_ms(lambda: run(name), 10),
                "bound_ms": nbytes / PEAK_BYTES_S * 1e3, "bytes": nbytes,
                "N": nets, "m": V.m, "mask": "random 0/1"}
        del per_net
    # the whole schedule against the gather it encodes. Routing the slot
    # numbers (exact in f32 up to 2^24) gives idx with out[n, k] = x[idx[n, k]];
    # x[idx] needs idx, which the network only encodes, so it is a yardstick
    # beside the schedule, not a library counterpart of any one pass.
    iota = torch.arange(V.m, dtype=torch.float32, device=DEVICE).view(-1, 128)
    (routed_iota,) = rd.hier_apply_batched((iota,), grp.pass_meta, grp.pass_masks, V.bl)
    gidx = routed_iota.view(N, V.m).to(torch.int64)
    del routed_iota
    flat = [p.view(V.m) for p in planes]
    outs = rd.hier_apply_batched(planes, grp.pass_meta, grp.pass_masks, V.bl)
    if not all(torch.equal(o.view(N, V.m), f[gidx]) for o, f in zip(outs, flat)):
        raise AssertionError("class D V schedule differs from its composed gather")
    del outs
    schedule_ms = time_ms(lambda: rd.hier_apply_batched(
        planes, grp.pass_meta, grp.pass_masks, V.bl), 5)
    gather_ms = time_ms(lambda: [f[gidx] for f in flat], 5)
    # the whole REVERSED schedule against the transpose of that gather:
    # zeros.index_add_(0, idx, u) in f64, to 1e-12 of sum|u| per column (the
    # compensated merges of a df64 pair round at about 2^-47 each)
    flat_idx = _net_offsets(gidx)
    outs_t = rd.hier_apply_batched_t(us, grp.pass_meta, grp.pass_masks, V.bl, dfpair=True)
    transpose_err = _check_transpose(
        outs_t, flat_idx, us, 1e-12, "class D V schedule, reversed")
    del outs_t
    schedule_t_ms = time_ms(lambda: rd.hier_apply_batched_t(
        us, grp.pass_meta, grp.pass_masks, V.bl, dfpair=True), 5)
    index_add_ms = time_ms(lambda: [_index_add(flat_idx, u) for u in us], 5)
    del us, flat_idx
    # <G x, u> = <x, G^T u> with f64 planes through the same kernels
    x64 = torch.as_tensor(rng.standard_normal(V.m), device=DEVICE)
    u64 = torch.as_tensor(rng.standard_normal((N, V.m)), device=DEVICE)
    (gx,) = rd.hier_apply_batched(
        (x64.view(-1, 128),), grp.pass_meta, grp.pass_masks, V.bl)
    (gtu,) = rd.hier_apply_batched_t(
        (u64.view(N, -1, 128),), grp.pass_meta, grp.pass_masks, V.bl)
    lhs = (gx.view(N, V.m) * u64).sum(dim=1)
    rhs = gtu.view(N, V.m) @ x64
    dot_scale = (gx.view(N, V.m) * u64).abs().sum(dim=1)
    adjoint_identity_err = float(((lhs - rhs).abs() / dot_scale).max())
    if not adjoint_identity_err <= 1e-12:
        raise AssertionError(
            f"class D: <G x, u> != <x, G^T u>: {adjoint_identity_err:.3e} of sum|.|")
    del x64, u64, gx, gtu
    line = {"phase": "hier_class_d", "group_nets": N, "m": V.m, "bl": V.bl,
            "passes_checked": len(grp.pass_meta),
            "timed": {k: v["ms"] for k, v in timed.items()},
            "timed_adjoint": {k: v["ms"] for k, v in timed_t.items()},
            "schedule_ms": schedule_ms, "index_gather_ms": gather_ms,
            "schedule_t_ms": schedule_t_ms, "index_add_ms": index_add_ms,
            "transpose_max_err_over_sum_abs": transpose_err,
            "adjoint_identity_err_over_sum_abs": adjoint_identity_err,
            "bigshift_at_class_d_shapes": shift_extra,
            "dfmulred_group_product": k2_row["products"]["class D group"]}
    emit(line)
    return line


# ---------------------------------------------------------------------------
# Parboil: sgemm (kernel K12) and spmv (gather kernels, K1 / K11 in f32)
# ---------------------------------------------------------------------------

GEMM_SMALL = ((1, 1, 1), (17, 33, 5), (150, 90, 70), (300, 260, 600), (5, 7, 0))
GEMM_WIDE = ((4096, 4096, 4096), (4000, 3000, 1500))
# input kinds every shape is checked on: standard normal; U(0, 1), one sign,
# so that a biased accumulation shows; rows and columns scaled by 2^e, e in
# [-40, 40]; every value with 24 random significand bits, so that all three
# bf16 pieces are non-zero; standard normal with one column of A and one of
# Bt between bf16's largest finite value and f32's (see _gemm_operands)
GEMM_KINDS = ("normal", "positive", "wide", "dense_bits", "huge")


def _gemm_operand(rng, rows: int, k: int, kind: str) -> np.ndarray:
    if kind in ("normal", "huge"):
        return rng.standard_normal((rows, k)).astype(np.float32)
    if kind == "positive":
        return rng.random((rows, k)).astype(np.float32)
    if kind == "wide":
        e = rng.integers(-20, 21, size=(rows, 1)) + rng.integers(-20, 21, size=(1, k))
        return (rng.standard_normal((rows, k)) * np.exp2(e)).astype(np.float32)
    if kind == "dense_bits":  # 1.xxx (23 random fraction bits) * 2^[-4, 4], signed
        frac = rng.integers(0, 1 << 23, size=(rows, k)).astype(np.float64)
        sign = rng.choice([-1.0, 1.0], size=(rows, k))
        return (sign * (1.0 + frac * 2.0 ** -23)
                * np.exp2(rng.integers(-4, 5, size=(rows, k)))).astype(np.float32)
    raise ValueError(kind)


def _gemm_operands(rng, m: int, n: int, k: int, kind: str) -> tuple:
    """A [m, k] and Bt [n, k] of one kind, on the card. `huge`: column 0 of
    A and column 1 of Bt lie between bf16's largest finite value and f32's
    (either sign), the other operand's entries there in (-1/4, 1/4), so
    every product and sum stays finite."""
    a, bt = _gemm_operand(rng, m, k, kind), _gemm_operand(rng, n, k, kind)
    if kind == "huge":
        top = float(np.finfo(np.float32).max)
        for big, small, j in ((a, bt, 0), (bt, a, 1)):
            if j < k:
                big[:, j] = (rng.uniform(float(torch.finfo(torch.bfloat16).max), top,
                                         big.shape[0])
                             * rng.choice([-1.0, 1.0], big.shape[0]))
                small[:, j] = rng.uniform(-0.25, 0.25, small.shape[0])
    return torch.as_tensor(a, device=DEVICE), torch.as_tensor(bt, device=DEVICE)


def _gemm_check(gemm, a, bt, c, what: str) -> dict:
    """c (kernel K12) against the f64 product element by element, within
    K*2^-24*(|A| |B|^T) + 2^-24*|C|, and against the plain version (the f64
    product rounded to f32) by parboil's compare."""
    from lilac_tpu_torch.workloads.parboil_spmv import compare

    k = a.shape[1]
    c64 = a.double() @ bt.double().T
    bound = k * 2.0 ** -24 * (a.double().abs() @ bt.double().abs().T) \
        + 2.0 ** -24 * c64.abs()
    err = (c.double() - c64).abs()
    plain = gemm.matmul_nt_plain(a, bt)
    row = {"shape": list(map(int, (a.shape[0], bt.shape[0], k))),
           "max_err_over_bound": float((err / bound.clamp_min(1e-300)).max()),
           "max_abs_err_vs_plain": float((c - plain).abs().max()),
           "compare": compare(plain.cpu().numpy().ravel(), c.cpu().numpy().ravel())}
    if c.shape != plain.shape or not bool(torch.isfinite(c).all()) or not bool(
            (err <= bound).all()) or not row["compare"]:
        raise AssertionError(f"matmul_nt {what}: {row}")
    return row


def _split_bits_equal(gemm, a, bt) -> None:
    """split_bf16x3 against its plain version, bit for bit."""
    got = gemm.split_bf16x3(a, bt)
    want = gemm.split_bf16x3_plain(a, bt)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        if g.shape != w.shape or not torch.equal(g.view(torch.int16), w.view(torch.int16)):
            raise AssertionError(f"split_bf16x3 {tuple(a.shape)} != its plain version")


def phase_gemm(kernels: dict) -> dict:
    """K12 against its plain version at ragged small shapes (K = 0, and
    K = 5, 70, 600 that pad the pieces' rows) and at Parboil's width, on
    every input kind of GEMM_KINDS; split_bf16x3 bit for bit against its
    plain version; a non-contiguous and a misaligned operand give the same
    bits. Timed at n = 4096: K12 (split + GEMM), the GEMM and the split
    alone, beside the plain version and torch.matmul with TF32 off, with
    the launch configuration. Then sgemm.run_arrays at n = 4096 through the
    entry point, launch count set to 0 just before and read just after, and
    again with the reference's kernel name "pallas": K12 again, the same
    bits."""
    from lilac_tpu_torch.kernels import gemm
    from lilac_tpu_torch.workloads import sgemm

    rng = np.random.default_rng(31)

    def operands(m, n, k, kind):
        return _gemm_operands(rng, m, n, k, kind)

    checked = {kind: [] for kind in GEMM_KINDS}
    for kind in GEMM_KINDS:
        for m, n, k in GEMM_SMALL:
            a, bt = operands(m, n, k, kind)
            _split_bits_equal(gemm, a, bt)
            c = gemm.matmul_nt(a, bt)
            torch.cuda.synchronize()
            checked[kind].append(_gemm_check(gemm, a, bt, c, f"{(m, n, k)} {kind}"))
            # a transposed view (as read_col_major gives) and an operand one word
            # off 16-byte alignment give the same bits
            a_view = a.T.contiguous().T
            buf = torch.empty(a.numel() + 1, dtype=torch.float32, device=DEVICE)
            a_off = buf[1:].view(m, k)
            a_off.copy_(a)
            for other, how in ((a_view, "non-contiguous"), (a_off, "misaligned")):
                if not _bits_equal(gemm.matmul_nt(other, bt), c):
                    raise AssertionError(f"matmul_nt {(m, n, k)} {kind} {how} A differs")
    timed = None
    for m, n, k in GEMM_WIDE:
        for kind in GEMM_KINDS:
            a, bt = operands(m, n, k, kind)
            if kind in ("dense_bits", "huge"):
                _split_bits_equal(gemm, a, bt)
            c = gemm.matmul_nt(a, bt)
            torch.cuda.synchronize()
            checked[kind].append(_gemm_check(gemm, a, bt, c, f"{(m, n, k)} {kind}"))
            if timed is None and kind == "normal":  # Parboil's square bench shape
                timed = _gemm_timing(gemm, a, bt, checked[kind][-1])
            del a, bt, c
    torch.cuda.empty_cache()

    # the main path: sgemm.run_arrays at Parboil's bench width, kernel K12
    n = GEMM_WIDE[0][0]
    A = rng.standard_normal((n, n)).astype(np.float32)
    BT = rng.standard_normal((n, n)).astype(np.float32)
    gemm.matmul_nt.launches = 0
    C, res = sgemm.run_arrays(A, BT, kernel="cuda", device=DEVICE)
    launches = gemm.matmul_nt.launches
    if res.kernel != "cuda" or launches != 5:
        raise AssertionError(f"sgemm.run_arrays: kernel {res.kernel}, {launches} launches "
                             "(a warm-up and 4 repetitions expected)")
    run_check = _gemm_check(gemm, torch.as_tensor(A, device=DEVICE),
                            torch.as_tensor(BT, device=DEVICE),
                            torch.as_tensor(C, device=DEVICE), "sgemm.run_arrays")
    timed["launches"] = launches
    timed["launches_on"] = "sgemm.run_arrays, n = 4096 (a warm-up and 4 chained repetitions)"
    # the reference's name of its hand kernel (its default) runs K12 too
    gemm.matmul_nt.launches = 0
    C_ref_name, res_ref_name = sgemm.run_arrays(A, BT, kernel="pallas", device=DEVICE)
    timed["launches_pallas_name"] = gemm.matmul_nt.launches
    if res_ref_name.kernel != "cuda" or timed["launches_pallas_name"] != 5 \
            or not np.array_equal(C_ref_name.view(np.uint32), C.view(np.uint32)):
        raise AssertionError(f"sgemm.run_arrays(kernel='pallas'): {res_ref_name.kernel}, "
                             f"{timed['launches_pallas_name']} K12 launches")
    kernels["matmul_nt"] = timed
    line = {"phase": "gemm", "kinds": list(GEMM_KINDS),
            "max_err_over_bound": {kind: max(r["max_err_over_bound"] for r in rows)
                                   for kind, rows in checked.items()},
            "checked": checked,
            "k12_ms": timed["ms"], "gemm_ms": timed["gemm_ms"],
            "split_ms": timed["split_ms"], "k12_gflops": timed["gflops"],
            "plain_ms": timed["plain_ms"], "torch_matmul_ms": timed["library_ms"],
            "bound_ms": timed["bound_ms"], "bound_by": timed["bound_by"],
            "f32_bound_ms": timed["f32_bound_ms"], "launch": timed["launch"],
            "sgemm_run_arrays": {"time_s": res.time_s, "gflops": res.gflops,
                                 "launches": launches, **run_check}}
    emit(line)
    return line


def _gemm_timing(gemm, a, bt, check: dict) -> dict:
    """K12's row at one shape: the call (split + GEMM), each grid alone, the
    plain version and torch.matmul (TF32 off), the route's bound (8 bf16
    products a term on the tensor cores) and the FP32 bound beside it."""
    m, k = a.shape
    n = bt.shape[0]
    pa, pb = gemm.split_bf16x3(a, bt)
    ms = time_ms(lambda: gemm.matmul_nt(a, bt), 20)
    gemm_ms = time_ms(lambda: gemm.gemm_bf16x3(pa, pb), 20)
    split_ms = time_ms(lambda: gemm.split_bf16x3(a, bt), 20)
    plain_ms = time_ms(lambda: gemm.matmul_nt_plain(a, bt), 5)
    library_ms = time_ms(lambda: gemm.matmul_nt_torch(a, bt), 20)
    launch = gemm.gemm_launch_config(m, n, k)
    if launch["gemm"]["tile"][2] != gemm.KPAD:  # the pieces' rows pad to whole K tiles
        raise AssertionError(f"gemm.KPAD {gemm.KPAD} != the kernel's BK {launch['gemm']}")
    flops = 2.0 * m * n * k
    nbytes = 4 * (m * k + n * k + m * n)
    tb = nbytes / PEAK_BYTES_S * 1e3
    tf = 8 * flops / PEAK_BF16_FLOPS * 1e3
    return {
        "name": "matmul_nt", "route": "cuda",
        "source": "lilac_tpu_torch/csrc/gemm.cu",
        "replaces": "lilac_tpu/kernels/pallas_gemm.py:46",
        "launches": 0, "max_abs_err": check["max_abs_err_vs_plain"],
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(tb, tf), "bound_by": "bytes" if tb >= tf else "operations",
        "library_ms": library_ms,
        "library": "torch.matmul, allow_tf32 = False",
        "f32_bound_ms": flops / PEAK_F32_FLOPS * 1e3,
        "gemm_ms": gemm_ms, "split_ms": split_ms,
        "grids_per_call": 2,
        "launch": launch,
        "shape": {"M": m, "N": n, "K": k, "dtype": "float32"},
        "bytes": nbytes, "flops": flops, "tensor_core_flops": 8 * flops,
        "gflops": flops / ms / 1e6, "library_gflops": flops / library_ms / 1e6,
    }


def phase_gemm_diag() -> dict:
    """How the tensor cores round K12's f32 accumulation (opt-in, not part
    of the whole run; times nothing). One-piece operands (pieces 1 and 2
    zero) go straight to gemm_bf16x3, so each row of C is one wgmma
    accumulation acc_hi of exact bf16 products whose exact sum needs more
    than 24 bits: against 1 (u = 2^-23, the ulp of 1) a small product in
    the same K step of 16 or in a later one, a tie, many small products,
    cancellation of two large ones, and bf16 / f32 subnormals. Each case
    reports the value it got against the exact sum rounded to nearest and
    toward zero."""
    from fractions import Fraction

    from lilac_tpu_torch.kernels import gemm

    u = 2.0 ** -23
    # (name, {k: a}, B row): B row 0 is all ones, 1 has 2^20 at k = 0, 2 has
    # 2^-70 at k = 0
    cases = [
        ("small_in_step", {0: 1.0, 1: 0.75 * u}, 0),
        ("small_in_step_negative", {0: -1.0, 1: -0.75 * u}, 0),
        ("tie_in_step", {0: 1.0, 1: 0.5 * u}, 0),
        ("above_tie_in_step", {0: 1.0, 1: 0.5 * u, 2: 2.0 ** -40}, 0),
        ("fifteen_quarters_in_step", {0: 1.0, **{j: 0.25 * u for j in range(1, 16)}}, 0),
        ("small_next_step", {0: 1.0, 16: 0.75 * u}, 0),
        ("small_next_step_negative", {0: -1.0, 16: -0.75 * u}, 0),
        ("small_next_tile", {0: 1.0, 64: 0.75 * u}, 0),
        ("sixteen_quarters_next_step", {0: 1.0, **{j: 0.25 * u for j in range(16, 32)}}, 0),
        ("cancel_in_step", {0: 1.0, 1: -1.0, 2: 2.0 ** -30}, 0),
        ("cancel_across_steps", {0: 1.0, 16: -1.0, 17: 2.0 ** -30}, 0),
        ("bf16_subnormal_piece", {0: 2.0 ** -130}, 1),
        ("f32_subnormal_product", {0: 2.0 ** -70}, 2),
    ]
    K = 128
    M = len(cases)
    A = np.zeros((M, K), dtype=np.float64)
    for i, (_, vals, _) in enumerate(cases):
        for k, v in vals.items():
            A[i, k] = v
    B = np.zeros((3, K))
    B[0, :] = 1.0
    B[1, 0] = 2.0 ** 20
    B[2, 0] = 2.0 ** -70
    pa = torch.zeros((3, M, K), dtype=torch.bfloat16, device=DEVICE)
    pb = torch.zeros((3, 3, K), dtype=torch.bfloat16, device=DEVICE)
    pa[0] = torch.as_tensor(A.astype(np.float32), device=DEVICE).to(torch.bfloat16)
    pb[0] = torch.as_tensor(B.astype(np.float32), device=DEVICE).to(torch.bfloat16)
    # every value above is a bf16 (a subnormal one too), so the pieces are exact
    if not torch.equal(pa[0].double().cpu(), torch.as_tensor(A)) or not torch.equal(
            pb[0].double().cpu(), torch.as_tensor(B)):
        raise AssertionError("gemm_diag: an input is not a bf16")
    c = gemm.gemm_bf16x3(pa, pb).cpu().numpy()
    rows = []
    for i, (name, vals, brow) in enumerate(cases):
        exact = sum(Fraction(v) * Fraction(B[brow, k]) for k, v in vals.items())
        rn = np.float32(float(exact))  # f64 holds every exact sum here
        rz = np.nextafter(rn, np.float32(0)) if abs(Fraction(float(rn))) > abs(exact) else rn
        got = np.float32(c[i, brow])
        how = "nearest" if got == rn else "toward zero" if got == rz else "other"
        ulp = float(np.spacing(np.float32(max(abs(float(exact)), 2.0 ** -149))))
        rows.append({"case": name, "exact": float(exact), "got": float(got),
                     "nearest": float(rn), "toward_zero": float(rz), "matches": how,
                     "err_ulps": float(abs(Fraction(float(got)) - exact) / Fraction(ulp))})
    # the cases where nearest and toward zero differ by a whole ulp
    decisive = {r["matches"] for r in rows
                if r["case"].startswith("small_") or r["case"] == "above_tie_in_step"}
    verdict = decisive.pop() if len(decisive) == 1 else "mixed"
    line = {"phase": "gemm_diag", "accumulation": verdict, "cases": rows}
    emit(line)
    return line


# Parboil's large spmv dataset, Dubcova3 (parboil_spmv.DATASETS["large"]):
# 146 689 rows, about 3.6 M entries after mirroring its symmetric file
PARBOIL_ROWS = 146_689


# the plain-float `auto` plans of this script past SpmvPlan's reuse rule
# (path, the kernel taken, row stats), noted where each runs; phase tools
# prints the committed model's label for each
AUTO_PATHS: list = []

# the kernel each of those paths must take, written down per card. On the
# card the committed model names (lilac_tpu_torch/autotune/model.json), the
# model serves inside its corpus (rows_h100.jsonl: at most 250 000 rows and
# 13.0 M entries): Parboil's 146 689 rows of spread lengths take xla_csr, as
# every random-CRS and bimodal row of 1.6 to 3.9 M entries there does. The
# 1M-node graphs lie beyond the corpus, so the heuristic serves them
# (bucketed ELL: rows spread), as xla_sell won the corpus's largest
# power-law graphs (150 000 nodes, 16 a row). On any other card the
# heuristic serves every path.
AUTO_HEURISTIC = {"parboil spmv": "xla_sell", "pagerank 1M": "xla_sell",
                  "bfs 1M": "xla_sell"}
AUTO_EXPECTED = {"NVIDIA H100 80GB HBM3": {**AUTO_HEURISTIC, "parboil spmv": "xla_csr"}}


def _note_auto(what: str, plan) -> None:
    want = AUTO_EXPECTED.get(torch.cuda.get_device_name(0), AUTO_HEURISTIC)[what]
    AUTO_PATHS.append({"path": what, "kernel": plan.kernel, "dtype": plan.dtype,
                       "row_stats": dict(plan.row_stats)})
    if plan.kernel != want:
        raise AssertionError(f"{what}: auto took {plan.kernel}, this card's is {want}")


def _write_parboil_inputs(root: str, rng):
    """A symmetric MatrixMarket file at Dubcova3's scale with unequal row
    lengths (1% of the rows about eight times as long as the rest), an f32
    vector.bin and the golden output (the f64 host product rounded to f32).
    Returns (paths, mirrored (rows, cols, vals) for host checks)."""
    from lilac_tpu_torch.workloads import parboil_spmv as pv

    n = PARBOIL_ROWS
    k = rng.integers(6, 17, size=n)  # entries per row before the fold below
    k[rng.choice(n, size=n // 100, replace=False)] = 100
    r = np.repeat(np.arange(n), k)
    c = rng.integers(0, n, size=len(r))
    r, c = np.maximum(r, c), np.minimum(r, c)  # lower triangle (duplicates sum)
    v = rng.standard_normal(len(r))
    d = rng.standard_normal(n) + 8.0
    os.makedirs(root, exist_ok=True)
    mtx = os.path.join(root, "matrix.mtx")
    with open(mtx, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real symmetric\n")
        f.write("% lilac_tpu_torch chip_smoke: Dubcova3-scale synthetic\n")
        f.write(f"{n} {n} {n + len(r)}\n")
        # repr of a Python float reads back as the same double
        f.write("".join(f"{i} {i} {x!r}\n" for i, x in enumerate(d.tolist(), 1)))
        for lo in range(0, len(r), 1 << 18):
            sl = slice(lo, lo + (1 << 18))
            f.write("".join(f"{a + 1} {b + 1} {x!r}\n" for a, b, x in zip(
                r[sl].tolist(), c[sl].tolist(), v[sl].tolist())))
    off = r != c
    rows = np.concatenate([np.arange(n), r, c[off]])
    cols = np.concatenate([np.arange(n), c, r[off]])
    vals = np.concatenate([d, v, v[off]])
    x = rng.standard_normal(n).astype(np.float32)
    vec = os.path.join(root, "vector.bin")
    x.astype("<f4").tofile(vec)
    golden = os.path.join(root, "golden.out")
    y = np.bincount(rows, weights=vals * x.astype(np.float64)[cols], minlength=n)
    pv.write_output(golden, y.astype(np.float32))
    return (mtx, vec, golden), (rows, cols, vals)


def phase_parboil(kernels: dict) -> dict:
    """Parboil spmv at Dubcova3's scale through the entry point
    (parboil_spmv.run: read_matrix_market -> SpmvPlan -> 2 x 50 chained
    products), matched against the golden output: with kernel="auto" (the
    selector's gather kernel; row lengths spread, so bucketed ELL) and with
    kernel="routed" (a single-table f32 plan: K1), launch counts set to 0
    just before each run and read just after. Then the routed plan's
    transpose product (K11 in f32) against the host's f64 A^T u, to 1e-5 of
    sum |a u| per column."""
    from lilac_tpu_torch.config import cfg
    from lilac_tpu_torch.kernels import dfmulred as dfk
    from lilac_tpu_torch.kernels import routed as rd
    from lilac_tpu_torch.workloads import parboil_spmv as pv

    rng = np.random.default_rng(37)
    t0 = time.time()
    root = os.path.join(cfg().resolved_data_dir(), "parboil_smoke")
    (mtx, vec, golden), (rows, cols, vals) = _write_parboil_inputs(root, rng)
    line = {"phase": "parboil_spmv", "rows": PARBOIL_ROWS,
            "inputs_written_s": round(time.time() - t0, 1), "runs": []}
    routed_plan = None
    for kernel in ("auto", "routed"):
        _reset_hier_counts(rd, dfk)
        t0 = time.time()
        res = pv.run(mtx, vec, golden_path=golden, kernel=kernel, device=DEVICE)
        wall = time.time() - t0
        k1, k11 = rd.routed_apply.launches, rd.routed_apply_t.launches
        st = res.plan.row_stats
        run = {"kernel_asked": kernel, "kernel": res.kernel, "nnz": res.nnz,
               "reps": res.reps, "time_s": res.time_s, "gflops": res.gflops,
               "matched": res.matched, "max_abs_err": res.max_abs_err,
               "wall_s_with_read_and_plan": round(wall, 2),
               "max_row": st["max_row"], "mean_row": st["mean_row"],
               "routed_apply_launches": k1, "routed_apply_grid_launches":
                   rd.routed_apply.stage_launches}
        line["runs"].append(run)
        if res.matched is not True or res.rows != PARBOIL_ROWS:
            raise AssertionError(f"parboil spmv {kernel}: {run}")
        if kernel == "auto":
            _note_auto("parboil spmv", res.plan)
            if not res.kernel.startswith("xla_") or k1 or k11:
                raise AssertionError(f"parboil auto ran {res.kernel} ({k1} K1 launches)")
        else:
            if res.kernel != "routed" or k1 != 2 * res.reps or k11:
                raise AssertionError(
                    f"parboil routed ran {res.kernel} with {k1} K1 launches "
                    f"({2 * res.reps} expected)")
            routed_plan = res.plan
            if "routed_apply" in kernels:
                kernels["routed_apply"]["launches_parboil_f32"] = k1
    # the transpose through the same routed plan (K11, one f32 plane)
    P = routed_plan
    u = rng.standard_normal(PARBOIL_ROWS).astype(np.float32)
    _reset_hier_counts(rd, dfk)
    got = P.vec_out(P.matvec_t(P.vec_in(u)))
    torch.cuda.synchronize()
    k11 = rd.routed_apply_t.launches
    u64 = u.astype(np.float64)
    want = np.bincount(cols, weights=vals * u64[rows], minlength=PARBOIL_ROWS)
    scale = np.bincount(cols, weights=np.abs(vals * u64[rows]), minlength=PARBOIL_ROWS)
    err = float((np.abs(got - want) / np.maximum(scale, 1e-300)).max())
    line["transpose"] = {"kernel": "routed (K11, f32)", "max_err_over_sum_abs": err,
                         "tol": 1e-5, "routed_apply_t_launches": k11,
                         "ms": time_ms(lambda: P.matvec_t(P.vec_in(u)), 10)}
    if k11 != 1 or got.shape != (PARBOIL_ROWS,) or not err <= 1e-5:
        raise AssertionError(f"parboil routed transpose: {line['transpose']}")
    if "routed_apply_t" in kernels:
        kernels["routed_apply_t"]["launches_parboil_f32"] = k11
    # K1 and K11 on the plan's own network in f32 (one plane), bit for bit
    A = P.A
    nets = A.masks.shape[0]
    x = torch.as_tensor(rng.standard_normal(A.m).astype(np.float32),
                        device=DEVICE).view(-1, 128)
    us = _adj_planes(rng, (nets, A.m // 128, 128), np.float32, 1, False)
    got, got_t = (rd.routed_apply([x], A.masks, A.kinds, A.dists),
                  rd.routed_apply_t(us, A.masks, A.kinds, A.dists))
    torch.cuda.synchronize()
    if not (_bits_equal(got[0], rd.routed_apply_plain([x], A.masks, A.kinds, A.dists)[0])
            and _bits_equal(got_t[0], rd.routed_apply_t_plain(
                us, A.masks, A.kinds, A.dists)[0])):
        raise AssertionError("parboil routed plan: K1 / K11 != plain in f32")
    tile = rd.routed_tile(1, 4, rd.smem_optin_bytes(DEVICE))
    line["routed_network_f32"] = {
        "m": A.m, "nets": nets, "stages": len(A.kinds), "tile": tile,
        "passes": [list(p) for p in rd.routed_passes(A.kinds, A.dists, A.m, tile)],
        "routed_apply_ms": time_ms(lambda: rd.routed_apply([x], A.masks, A.kinds, A.dists), 20),
        "routed_apply_t_ms": time_ms(lambda: rd.routed_apply_t(us, A.masks, A.kinds, A.dists), 20),
        "bit_identical_to_plain": True}
    emit(line)
    return line


def _npb_line(res, **extra) -> dict:
    return {"class": res.class_name, "dtype": res.dtype, "kernel": res.kernel,
            "verified": bool(res.verified), "zeta": res.zeta,
            "zeta_rel_err": res.rel_err, "rnorm_last": res.rnorm_last,
            "time_s": res.time_s, "mops": res.mops, "niter": res.niter, **extra}


def phase_npb_small() -> list:
    """Class S through both operators in all three value policies, then
    through two registry kernels on the assembled matrix."""
    import os

    from lilac_tpu_torch.workloads import npb_cg

    lines = []
    zetas = {}
    for segmode in ("routed", "single"):
        os.environ["LILAC_FACTORED_SEGMODE"] = segmode
        try:
            for dtype in ("f32", "f64", "df64"):
                res = npb_cg.run("S", dtype=dtype, device=DEVICE)
                lines.append(_npb_line(res, segmode=segmode))
                zetas[(segmode, dtype)] = res.zeta
                if not np.isfinite([res.zeta, res.rnorm_last]).all():
                    raise AssertionError(f"class S {segmode} {dtype}: not finite")
                # f32 cannot reach 1e-10: it is held to 1e-5 (the reference's bar)
                ok = res.verified if dtype != "f32" else res.rel_err <= 1e-5
                if not ok:
                    raise AssertionError(
                        f"class S {segmode} {dtype}: zeta rel err {res.rel_err:.3e}")
        finally:
            del os.environ["LILAC_FACTORED_SEGMODE"]
    for dtype in ("f64", "df64"):
        a, b = zetas[("routed", dtype)], zetas[("single", dtype)]
        if abs(a - b) > 1e-11 * abs(b):
            raise AssertionError(f"class S {dtype}: routed {a} vs gather {b}")
    lines += _mixed_small()
    # an assembled matrix through SpmvPlan and a registry kernel, as
    # `bench run --bench npb --impl <kernel>` runs it
    for kernel, dtype in (("xla_ell", "f64"), ("xla_sell_df", "df64")):
        res = npb_cg.run("S", kernel=kernel, dtype=dtype, device=DEVICE)
        lines.append(_npb_line(res, segmode=None))
        b = zetas[("routed", dtype)]
        if res.kernel != kernel or not res.verified or abs(res.zeta - b) > 1e-10 * abs(b):
            raise AssertionError(f"class S {kernel} {dtype}: {lines[-1]} vs factored {b}")
    emit({"phase": "npb_small", "runs": lines})
    return lines


def _mixed_small() -> list:
    """Classes S and W in df64 through the mixed layout (V a hierarchical
    plan, V^T the JagELLT gather), uncut and verified."""
    from lilac_tpu_torch.workloads import npb_cg

    lines = []
    for cls in ("S", "W"):
        res = _with_env({"LILAC_FACTORED_SEGMODE": "mixed"},
                        lambda: npb_cg.run(cls, dtype="df64", device=DEVICE))
        lines.append(_npb_line(res, segmode="mixed"))
        if res.kernel != "factored_mixed_df" or not res.verified:
            raise AssertionError(f"class {cls} mixed layout: {lines[-1]}")
    return lines


def _with_env(env: dict, fn):
    """fn() with the given LILAC_* variables set, restored after."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k, v in old.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def _steps(env_name: str, class_name: str) -> int:
    from lilac_tpu_torch.generate.npb import CLASSES

    full = CLASSES[class_name].niter
    return max(1, min(full, int(os.environ.get(env_name, full))))


def _check_npb(res, line, class_name: str, steps: int) -> None:
    """An uncut run must pass NPB's verification. A run cut in depth is held
    to the native-f64 gather operator's zeta history on the card instead."""
    from lilac_tpu_torch.generate.npb import CLASSES
    from lilac_tpu_torch.workloads import npb_cg

    if res.kernel != "factored_routed_df":
        raise AssertionError(f"main path ran {res.kernel}, not the routed operator")
    if res.niter != steps or not np.isfinite(
            [res.zeta, res.rnorm_last, *res.zeta_history]).all():
        raise AssertionError(f"class {class_name}: {res.niter} steps, not finite?")
    if steps == CLASSES[class_name].niter:
        if not res.verified:
            raise AssertionError(f"class {class_name} df64 failed verification: {line}")
        return
    t0 = time.time()
    ref = _with_env(
        {"LILAC_FACTORED_SEGMODE": "single"},
        lambda: npb_cg.run(class_name, dtype="f64", niter=steps, device=DEVICE))
    rel = np.abs(res.zeta_history - ref.zeta_history) / np.abs(ref.zeta_history)
    cut = {"phase": "npb_cut", "class": class_name, "outer_steps": steps,
           "of": CLASSES[class_name].niter, "reference": ref.kernel + " f64",
           "zeta_history_max_rel_diff": float(rel.max()),
           "reference_wall_s": round(time.time() - t0, 1)}
    emit(cut)
    if ref.kernel != "factored_gather" or not rel.max() <= 1e-10:
        raise AssertionError(f"class {class_name} cut run disagrees: {cut}")


def _compare_histories(a, b, what: str, tol: float = 1e-12) -> float:
    """The zeta histories of two runs over their common outer steps, to
    `tol` relative: the two factored_vt modes compute the same products in
    another order of df64 sums."""
    k = min(len(a.zeta_history), len(b.zeta_history))
    rel = np.abs(a.zeta_history[:k] - b.zeta_history[:k]) / np.abs(b.zeta_history[:k])
    worst = float(rel.max())
    emit({"phase": "vt_modes", "what": what, "outer_steps_compared": k,
          "factored_vt": [a.factored_vt, b.factored_vt],
          "zeta_history_max_rel_diff": worst, "tol": tol})
    if {a.factored_vt, b.factored_vt} != {"adj", "plan"} or not worst <= tol:
        raise AssertionError(f"{what}: adj and plan disagree: {worst:.3e}")
    return worst


def phase_main_path_c(kernels: dict) -> dict:
    """Main path through the single-table plans: npb_cg.run("C") in df64 through
    the routed operator with factored_vt as `auto` resolves it there (plan:
    kernels K1 and K2), launch counts set to 0 just before and read just
    after. Then a few outer steps with factored_vt=adj (V's plan forwards by
    K1 and in reverse by K11), counts again set to 0 before and read after,
    held against the first run's zeta history."""
    from lilac_tpu_torch.kernels import dfmulred as dfk
    from lilac_tpu_torch.kernels import routed as rd
    from lilac_tpu_torch.workloads import npb_cg

    steps = _steps("CHIP_SMOKE_C_STEPS", "C")
    _reset_hier_counts(rd, dfk)
    t0 = time.time()
    res = npb_cg.run("C", dtype="df64", kernel="factored", niter=steps, device=DEVICE)
    wall = time.time() - t0
    kernels["routed_apply"]["launches"] = rd.routed_apply.launches
    kernels["routed_apply"]["grid_launches"] = rd.routed_apply.stage_launches
    k2_c = dfk.dfmulred.launches
    dot_c = _check_dfdot(kernels, res, "C")
    _check_dfops(kernels, res.niter + 1, "class_c")
    matvecs = (res.niter + 1) * 26  # the untimed warm-up step included
    line = _npb_line(
        res, phase="npb", wall_s=wall, matvecs=matvecs,
        routed_apply_launches=rd.routed_apply.launches,
        routed_apply_grid_launches=rd.routed_apply.stage_launches,
        routed_apply_t_launches=rd.routed_apply_t.launches,
        dfmulred_launches=k2_c, dfdot_launches=dot_c, full_width="class C",
        outer_steps=steps)
    emit(line)
    _check_npb(res, line, "C", steps)
    if res.factored_vt != "plan" or rd.routed_apply_t.launches:
        raise AssertionError("class C: auto did not resolve to factored_vt=plan")
    if rd.routed_apply.launches != 2 * matvecs:
        raise AssertionError(
            f"routed_apply launched {rd.routed_apply.launches} times on "
            f"{matvecs} matvecs (two per matvec expected)")
    if k2_c != 2 * matvecs:
        raise AssertionError(f"dfmulred launched {k2_c} times on {matvecs} matvecs "
                             "(one a product, two a matvec expected)")
    kernels["dfmulred"]["launches"] = k2_c
    kernels["dfmulred"]["launches_class_c"] = k2_c

    # the other mode, cut in depth: V^T through V's own plan in reverse
    adj_steps = min(3, steps)
    _reset_hier_counts(rd, dfk)
    t0 = time.time()
    adj = _with_env(
        {"LILAC_FACTORED_VT": "adj"},
        lambda: npb_cg.run("C", dtype="df64", niter=adj_steps, device=DEVICE))
    k11 = rd.routed_apply_t.launches
    matvecs_adj = (adj.niter + 1) * 26
    emit(_npb_line(
        adj, phase="npb", wall_s=time.time() - t0, matvecs=matvecs_adj,
        factored_vt=adj.factored_vt, routed_apply_launches=rd.routed_apply.launches,
        routed_apply_t_launches=k11,
        routed_apply_t_grid_launches=rd.routed_apply_t.stage_launches,
        full_width="class C", outer_steps=adj_steps))
    if (k11 != matvecs_adj or rd.routed_apply.launches != matvecs_adj
            or dfk.dfmulred.launches != matvecs_adj):
        raise AssertionError(
            f"class C adj: routed_apply {rd.routed_apply.launches}, routed_apply_t "
            f"{k11}, dfmulred {dfk.dfmulred.launches} launches on {matvecs_adj} "
            "matvecs (one each per matvec expected)")
    _compare_histories(adj, res, "class C")
    kernels["routed_apply_t"]["launches"] = k11
    kernels["routed_apply_t"]["grid_launches"] = rd.routed_apply_t.stage_launches
    kernels["routed_apply_t"]["launches_on"] = (
        f"NPB class C, factored_vt=adj, {adj_steps} outer steps")
    return line


def phase_cg_solve() -> dict:
    """cg_solve (CG to a residual tolerance, one host read of its stopping
    test an iteration) on NPB class C's matrix, b = ones, rtol = 1e-10,
    maxit = 1000: through the factored routed plan in df64 (kernels K1 and
    K2, launch counts set to 0 before and read after) and through
    SpmvPlan(kernel="xla_ell") in f64 on the assembled matrix. Each must
    stop before maxit with ||b - A x||_2 / ||b||_2 <= 10 rtol, A x taken in
    f64 on the host by scipy from the assembled CSR. The factored plan runs
    in its relabelled column space (kernels/factored.py), so its x is
    mapped back first."""
    import scipy.sparse as sp

    from lilac_tpu_torch.generate.npb import CLASSES, _generate_triples, make_cg_matrix
    from lilac_tpu_torch.kernels import dfmulred as dfk
    from lilac_tpu_torch.kernels import routed as rd
    from lilac_tpu_torch.plan import FactoredNPBPlan, SpmvPlan
    from lilac_tpu_torch.solvers.algebra import get_algebra
    from lilac_tpu_torch.solvers.cg import cg_solve

    cls = CLASSES["C"]
    n = cls.na
    rtol, maxit = 1e-10, 1000
    t0 = time.time()
    indptr, indices, data, _ = make_cg_matrix("C")
    A = sp.csr_matrix((data, indices, indptr), shape=(n, n))
    # the factored plan's column labels: by descending count in V, stable
    _, ivc, _ = _generate_triples(cls)
    sigma = np.argsort(-np.bincount(ivc - 1, minlength=n), kind="stable")
    rank = np.empty(n, dtype=np.int64)
    rank[sigma] = np.arange(n)
    setup_s = time.time() - t0
    b = np.ones(n)
    line = {"phase": "cg_solve", "class": "C", "n": n, "nnz_assembled": int(A.nnz),
            "rtol": rtol, "maxit": maxit, "setup_s": round(setup_s, 2), "runs": []}
    for name, dtype, make, relabel in (
            ("factored routed", "df64",
             lambda: FactoredNPBPlan("C", dtype="df64", device=DEVICE), True),
            ("xla_ell", "f64",
             lambda: SpmvPlan(indptr, indices, data, (n, n), dtype="f64",
                              kernel="xla_ell", device=DEVICE), False)):
        t0 = time.time()
        plan = make()
        build_s = time.time() - t0
        _reset_hier_counts(rd, dfk)
        t0 = time.time()
        x, iters, rnorm = cg_solve(plan.matvec_with, get_algebra(dtype, device=DEVICE),
                                   plan.A, plan.vec_in(b), rtol=rtol, maxit=maxit)
        xh = plan.vec_out(x)
        solve_s = time.time() - t0
        if relabel:
            xh = xh[rank]
        rel_res = float(np.linalg.norm(b - A @ xh) / np.linalg.norm(b))
        run = {"operator": plan.kernel, "dtype": dtype, "iterations": iters,
               "rnorm": float(np.asarray(plan.vec_out(rnorm))),
               "true_rel_residual": rel_res, "build_s": round(build_s, 2),
               "solve_s": solve_s, "routed_apply_launches": rd.routed_apply.launches,
               "dfmulred_launches": dfk.dfmulred.launches}
        line["runs"].append(run)
        if not isinstance(iters, int) or not 0 < iters < maxit:
            raise AssertionError(f"cg_solve {name}: {iters} iterations (maxit {maxit})")
        if not np.isfinite(xh).all() or not rel_res <= 10 * rtol:
            raise AssertionError(f"cg_solve {name}: ||b - A x|| / ||b|| = {rel_res:.3e}")
        if relabel and not (rd.routed_apply.launches >= 2 * iters
                            and dfk.dfmulred.launches >= 2 * iters):
            raise AssertionError(f"cg_solve {name}: K1 / K2 not on the path: {run}")
        del plan, x
    emit(line)
    return line


def _general_layouts() -> dict:
    """The general 400 000-row matrix of phase_hier_general (sorted by
    column within each row, as the converters need) through
    csr_to_seg_ell_scan and multi-segment csr_to_seg_bucket_ell at their
    default seg_size (3 segments) in f64 and df64, against scipy's A x in
    f64: to 1e-13 (f64) and 4e-14 (df64) of sum |a x| a row."""
    import scipy.sparse as sp

    from lilac_tpu_torch.formats import convert as tconv
    from lilac_tpu_torch.kernels import gather
    from lilac_tpu_torch.ops import dfloat as df
    from lilac_tpu_torch.utils.profiling import tensor_bytes

    n = 400_000
    rng = np.random.default_rng(23)
    indptr, indices, data = _general_matrix(rng, n)
    x = rng.standard_normal(n)
    rows = np.repeat(np.arange(n), np.diff(indptr))
    ip, ix, vv = tconv.coo_to_csr_arrays(rows, indices, data, (n, n), sum_duplicates=False)
    A = sp.csr_matrix((vv.copy(), ix.copy(), ip.copy()), shape=(n, n))
    want = A @ x
    scale = abs(A) @ np.abs(x)
    out = {}
    for dtype, tol in (("f64", 1e-13), ("df64", 4e-14)):
        vals = df.split_f64_np(vv) if dtype == "df64" else vv
        xin = df.from_f64(x, device=DEVICE) if dtype == "df64" else torch.as_tensor(
            x, device=DEVICE)
        for layout, build, spmv in (
                ("SegELLScan", tconv.csr_to_seg_ell_scan,
                 gather.seg_ell_scan_spmv_df if dtype == "df64" else gather.seg_ell_scan_spmv),
                ("SegBucketELL", tconv.csr_to_seg_bucket_ell,
                 gather.seg_bucket_ell_spmv_df if dtype == "df64"
                 else gather.seg_bucket_ell_spmv)):
            M = build(ip, ix, vals, (n, n), device=DEVICE)
            got = spmv(M, xin)
            got = df.to_f64(got) if dtype == "df64" else got.cpu().numpy()
            err = float((np.abs(got - want) / scale).max())
            segs = (M.nseg if layout == "SegELLScan"
                    else sum(1 for p in M.parts if p[2] >= 0))
            tail = (M.tail_data is not None if layout == "SegELLScan"
                    else any(p[2] < 0 for p in M.parts))
            out[f"{layout} {dtype}"] = {
                "segments": segs, "tail": tail, "bytes_on_card": tensor_bytes(M),
                "max_err_over_sum_abs": err, "tol": tol,
                "ms": time_ms(lambda: spmv(M, xin), 5)}
            if got.shape != (n,) or not np.isfinite(got).all() or err > tol or segs != 3:
                raise AssertionError(f"general matrix {layout} {dtype}: {out}")
            del M
    return out


def phase_npb_scan(adj_res, adj_bytes: int, adj_build_s: float) -> dict:
    """The factored operator in the scan layout (factored_segmode=scan: V
    and V^T as SegELLScan, gathered one column segment at a time by plain
    torch): NPB classes S and W in df64, uncut and verified; class D in
    df64 for 3 outer steps (10 segments and a tail), its zeta history held
    to the adj run's first 3 to 1e-12 relative (the same arithmetic, df64
    sums in another order), with its bytes on the card, host build seconds
    and untraced step wall beside adj's; then the general matrix's two
    multi-segment layouts (_general_layouts)."""
    from lilac_tpu_torch.formats.sparse import SegELLScan
    from lilac_tpu_torch.plan import FactoredNPBPlan
    from lilac_tpu_torch.utils.profiling import tensor_bytes
    from lilac_tpu_torch.workloads import npb_cg

    scan = {"LILAC_FACTORED_SEGMODE": "scan"}
    line = {"phase": "npb_scan", "runs": []}
    for cls in ("S", "W"):
        res = _with_env(scan, lambda: npb_cg.run(cls, dtype="df64", device=DEVICE))
        line["runs"].append(_npb_line(res))
        if res.kernel != "factored_gather_df" or not res.verified:
            raise AssertionError(f"class {cls} scan layout: {line['runs'][-1]}")
    t0 = time.time()
    plan = _with_env(scan, lambda: FactoredNPBPlan("D", dtype="df64", device=DEVICE))
    build_s = time.time() - t0
    V, VT = plan.A.V, plan.A.VT
    if not (isinstance(V, SegELLScan) and isinstance(VT, SegELLScan)):
        raise AssertionError(f"class D scan: {type(V).__name__}, {type(VT).__name__}")
    steps = min(3, adj_res.niter)
    res = npb_cg.run("D", dtype="df64", niter=steps, plan=plan)
    rel = np.abs(res.zeta_history - adj_res.zeta_history[:steps]) / np.abs(
        adj_res.zeta_history[:steps])
    line["class_d"] = {
        **_npb_line(res), "nseg": [V.nseg, VT.nseg], "width": [V.width, VT.width],
        "tail_rows": [0 if M.tail_data is None else int(M.tail_data.shape[1])
                      for M in (V, VT)],
        "zeta_history_max_rel_diff_vs_adj": float(rel.max()), "tol": 1e-12,
        "bytes_on_card": {"scan": tensor_bytes(plan.A), "adj": adj_bytes},
        "host_build_s": {"scan": round(build_s, 2), "adj": round(adj_build_s, 2)},
        "untraced_step_wall_s": {"scan": res.time_s / res.niter,
                                 "adj": adj_res.time_s / adj_res.niter}}
    if V.nseg != 10 or VT.nseg != 10 or not rel.max() <= 1e-12:
        raise AssertionError(f"class D scan layout: {line['class_d']}")
    line["class_d_zeta_history"] = res.zeta_history.tolist()
    del plan, V, VT
    torch.cuda.empty_cache()
    line["general_matrix"] = _general_layouts()
    emit(line)
    return line


FWD_D = ("routed_apply_sliced_b", "butterfly_apply_b", "window_shift_apply_b")
ADJ_D = ("routed_apply_sliced_bt", "butterfly_apply_bt", "window_shift_apply_bt")


def phase_main_path_d(kernels: dict, plan_d):
    """Main path through ONE hierarchical plan: npb_cg.run("D") in df64 at full
    na = 1 500 000 with factored_vt=adj (V forwards by K3, K4, K5, in reverse
    by K7, K8, K9, and K2; K6 / K10 where the plan holds a block-aligned
    shift). Returns (line, result)."""
    from lilac_tpu_torch.kernels import dfmulred as dfk
    from lilac_tpu_torch.kernels import routed as rd
    from lilac_tpu_torch.kernels import routed_spmv as rs
    from lilac_tpu_torch.workloads import npb_cg

    steps = _steps("CHIP_SMOKE_D_STEPS", "D")
    _reset_hier_counts(rd, dfk)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    res = npb_cg.run("D", dtype="df64", niter=steps, plan=plan_d)
    wall = time.time() - t0
    counts = _hier_counts(rd)
    k2_d = dfk.dfmulred.launches
    dot_d = _check_dfdot(kernels, res, "D")
    _check_dfops(kernels, res.niter + 1, "class_d")
    matvecs = (res.niter + 1) * 26
    line = _npb_line(
        res, phase="npb", wall_s=wall, matvecs=matvecs, launches=counts,
        dfmulred_launches=k2_d, dfdot_launches=dot_d, full_width="class D, na = 1500000",
        outer_steps=steps, factored_vt=res.factored_vt,
        plan_bytes_on_card=rs.plan_bytes(plan_d.A.V),
        peak_device_bytes=torch.cuda.max_memory_allocated())
    emit(line)
    _check_npb(res, line, "D", steps)
    if res.factored_vt != "adj":
        raise AssertionError("class D main path did not run factored_vt=adj")
    if rd.routed_apply.launches or rd.routed_apply_t.launches:
        raise AssertionError("class D went through a single-table kernel")
    for name in FWD_D + ADJ_D:
        if counts[name] < matvecs:
            raise AssertionError(f"{name} launched {counts[name]} times on "
                                 f"{matvecs} matvecs of class D")
        kernels[name]["launches"] = counts[name]
        kernels[name]["launches_on"] = (
            f"NPB class D, factored_vt=adj, {steps} outer steps")
    for name in ("bigshift_apply_b", "bigshift_apply_bt"):
        if counts[name]:
            kernels[name]["launches_class_d"] = counts[name]
    ngroups = len(plan_d.A.V.groups)
    if k2_d != ngroups * matvecs:
        raise AssertionError(f"dfmulred launched {k2_d} times on {matvecs} matvecs of "
                             f"class D (one a packed group, {ngroups} a matvec expected)")
    kernels["dfmulred"]["launches_class_d"] = k2_d
    kernels["dfmulred"]["launches"] += k2_d
    return line, res


# class D in the mixed layout against adj's first outer steps: the zeta
# history to 1e-12 relative (V's products are the same bits, V^T's df64 sums
# run in another order, as in the scan layout): the zeta check is the one
# that tells a right product from a wrong one. rnorm, the residual after 25
# CG steps, sits at df64's rounding floor (1e-12 to 4e-14 at classes S and
# W), where two orders of the same sums differ by 5 to 15% of it (gather,
# mixed and routed layouts on the CPU); at class D it differed from adj's by
# at most 1.5% (an H100 at 700 W), and is held to 0.1 relative
MIXED_D_STEPS = 3
MIXED_RNORM_TOL = 0.1


def phase_mixed_d(kernels: dict, adj_res, adj_bytes: int, class_name: str = "D"):
    """The mixed layout at class D (factored_segmode=mixed,
    factored_vt=plan) through FactoredNPBPlan: V is the hierarchical plan
    file the adj run just wrote, loaded and not rebuilt (the build function
    is counted and the file's mtime read), V^T the JagELLT gather in df64.
    3 outer steps with the counts set to 0 before and read after: K3-K5 and
    K2 on V, no adjoint and no single-table kernel; the zeta and rnorm
    histories held to the adj run's first 3. Returns (line, result)."""
    from lilac_tpu_torch.config import cfg
    from lilac_tpu_torch.formats.sparse import JagELLT
    from lilac_tpu_torch.kernels import dfmulred as dfk
    from lilac_tpu_torch.kernels import factored as fac
    from lilac_tpu_torch.kernels import routed as rd
    from lilac_tpu_torch.kernels import routed_spmv as rs
    from lilac_tpu_torch.plan import FactoredNPBPlan
    from lilac_tpu_torch.utils.profiling import tensor_bytes
    from lilac_tpu_torch.workloads import npb_cg

    env = {"LILAC_FACTORED_SEGMODE": "mixed", "LILAC_FACTORED_VT": "plan"}
    path = os.path.join(cfg().resolved_data_dir(),
                        f"routed2_{class_name}_df64_V{rs.plan_tag(cfg(), hier=True)}.npz")
    if not os.path.exists(path):
        raise AssertionError(f"class {class_name} mixed: no V plan file {path} from the "
                             "adj run")
    mtime = os.stat(path).st_mtime_ns
    builds = []
    build_hier = fac._build_hier_plan

    def counted(*a, **k):
        builds.append(a[0])
        return build_hier(*a, **k)

    fac._build_hier_plan = counted
    t0 = time.time()
    try:
        plan = _with_env(env, lambda: FactoredNPBPlan(class_name, dtype="df64",
                                                      device=DEVICE))
    finally:
        fac._build_hier_plan = build_hier
    build_s = time.time() - t0
    V, VT = plan.A.V, plan.A.VT
    if builds or os.stat(path).st_mtime_ns != mtime:
        raise AssertionError(f"class D mixed rebuilt V ({builds}) instead of loading {path}")
    if plan.kernel != "factored_mixed_df" or plan.factored_vt != "plan" or not (
            isinstance(V, rs.RoutedMatHierP) and isinstance(VT, JagELLT)):
        raise AssertionError(f"class D mixed: {plan.kernel}, {type(V).__name__}, "
                             f"{type(VT).__name__}")
    v_bytes, vt_bytes = rs.plan_bytes(V), tensor_bytes(VT)
    _reset_hier_counts(rd, dfk)
    steps = min(MIXED_D_STEPS, adj_res.niter)
    t0 = time.time()
    res = npb_cg.run(class_name, dtype="df64", niter=steps, plan=plan)
    wall = time.time() - t0
    counts = _hier_counts(rd)
    k2 = dfk.dfmulred.launches
    matvecs = (res.niter + 1) * 26
    zrel = np.abs(res.zeta_history - adj_res.zeta_history[:steps]) / np.abs(
        adj_res.zeta_history[:steps])
    rrel = np.abs(res.rnorm_history - adj_res.rnorm_history[:steps]) / np.abs(
        adj_res.rnorm_history[:steps])
    line = _npb_line(
        res, phase="npb_mixed", wall_s=wall, build_s=round(build_s, 2),
        v_loaded_from=os.path.basename(path), v_rebuilt=False, outer_steps=steps,
        matvecs=matvecs, launches={k: v for k, v in counts.items() if v},
        dfmulred_launches=k2,
        routed_apply_launches=rd.routed_apply.launches,
        jag_buckets=[[int(v.shape[0]), int(r)] for v, r in zip(VT.data_hi, VT.row_counts)],
        bytes_on_card={"mixed": v_bytes + vt_bytes, "V": v_bytes, "JagELLT": vt_bytes,
                       "adj": adj_bytes},
        untraced_step_wall_s={"mixed": res.time_s / res.niter,
                              "adj": adj_res.time_s / adj_res.niter},
        zeta_history_max_rel_diff_vs_adj=float(zrel.max()), zeta_tol=1e-12,
        rnorm_history_max_rel_diff_vs_adj=float(rrel.max()), rnorm_tol=MIXED_RNORM_TOL)
    emit(line)
    if not np.isfinite([*res.zeta_history, *res.rnorm_history]).all() \
            or not zrel.max() <= 1e-12 or not rrel.max() <= MIXED_RNORM_TOL:
        raise AssertionError(f"class D mixed disagrees with adj: {line}")
    if rd.routed_apply.launches or any(counts[name] for name in ADJ_D) \
            or any(counts[name] < matvecs for name in FWD_D) \
            or k2 != len(V.groups) * matvecs:
        raise AssertionError(f"class D mixed launches: {counts}, K2 {k2} on {matvecs} "
                             f"matvecs ({len(V.groups)} groups)")
    for name in FWD_D:
        kernels.setdefault(name, {"name": name})["launches_mixed_d"] = counts[name]
    kernels.setdefault("dfmulred", {"name": "dfmulred"})["launches_mixed_d"] = k2
    del plan, V, VT
    torch.cuda.empty_cache()
    return line, res


def _hold_to_gather(res, gather_hist, what: str, tol: float = 1e-12) -> float:
    """A cut run's zeta history against the gather operator's (the scan
    layout's) over their common outer steps, to `tol` relative."""
    k = min(len(res.zeta_history), len(gather_hist))
    rel = float((np.abs(res.zeta_history[:k] - gather_hist[:k])
                 / np.abs(gather_hist[:k])).max())
    emit({"phase": "vs_gather", "what": what, "outer_steps_compared": k,
          "zeta_history_max_rel_diff": rel, "tol": tol})
    if not rel <= tol:
        raise AssertionError(f"{what}: {rel:.3e} from the gather operator")
    return rel


def phase_plan_mode_d(kernels: dict, adj_res) -> dict:
    """The other mode at class D, cut in depth: two forward hierarchical plans
    (factored_vt=plan; V's comes from the file the adj build wrote, V^T's is
    built), a few outer steps, held against the adj run's zeta history."""
    from lilac_tpu_torch.kernels import dfmulred as dfk
    from lilac_tpu_torch.kernels import routed as rd
    from lilac_tpu_torch.kernels import routed_spmv as rs
    from lilac_tpu_torch.plan import FactoredNPBPlan
    from lilac_tpu_torch.workloads import npb_cg

    steps = min(3, adj_res.niter)
    t0 = time.time()
    plan = _with_env(
        {"LILAC_FACTORED_VT": "plan"},
        lambda: FactoredNPBPlan("D", dtype="df64", device=DEVICE))
    build_s = time.time() - t0
    V, VT = plan.A.V, plan.A.VT
    if plan.factored_vt != "plan" or not all(
            isinstance(p, rs.RoutedMatHierP) for p in (V, VT)):
        raise AssertionError(f"class D plan mode: {plan.factored_vt}, {type(VT).__name__}")
    emit({"phase": "plan", "class": "D", "factored_vt": "plan",
          "build_s": round(build_s, 2), "nets": [len(V.chunks), len(VT.chunks)],
          "groups": [[len(g.net_ids) for g in p.groups] for p in (V, VT)],
          "passes_per_matvec": [_pass_census(V), _pass_census(VT)],
          "unperm": [V.unperm is not None, VT.unperm is not None],
          "plan_bytes_on_card": [rs.plan_bytes(V), rs.plan_bytes(VT)]})
    _reset_hier_counts(rd, dfk)
    t0 = time.time()
    res = npb_cg.run("D", dtype="df64", niter=steps, plan=plan)
    counts = _hier_counts(rd)
    matvecs = (res.niter + 1) * 26
    line = _npb_line(
        res, phase="npb", wall_s=time.time() - t0, matvecs=matvecs, launches=counts,
        dfmulred_launches=dfk.dfmulred.launches, full_width="class D, na = 1500000",
        outer_steps=steps, factored_vt=res.factored_vt)
    emit(line)
    k2_groups = len(V.groups) + len(VT.groups)
    if dfk.dfmulred.launches != k2_groups * matvecs:
        raise AssertionError(f"plan mode: dfmulred launched {dfk.dfmulred.launches} times "
                             f"on {matvecs} matvecs ({k2_groups} a matvec expected)")
    for name in FWD_D:
        if counts[name] < 2 * matvecs:
            raise AssertionError(f"plan mode: {name} launched {counts[name]} times on "
                                 f"{matvecs} matvecs of class D")
        kernels[name]["launches_plan_mode"] = counts[name]
    if any(counts[name] for name in ADJ_NAMES):
        raise AssertionError(f"plan mode launched an adjoint kernel: {counts}")
    _compare_histories(adj_res, res, "class D")
    return line


def _pass_census(P) -> dict:
    """Kernel launches one matvec makes through a packed hier plan, by kind."""
    census = {k: 0 for k in PASS_FNS}
    for g in P.groups:
        for mt in g.pass_meta:
            census[mt[0]] += 1
    return census


def build_plan_d():
    """Class D's plan through the entry point a user calls (FactoredNPBPlan)
    with factored_vt left at `auto`: it must resolve to adj and hold ONE
    hierarchical plan for both directions."""
    from lilac_tpu_torch.kernels import routed_spmv as rs
    from lilac_tpu_torch.plan import FactoredNPBPlan

    if "LILAC_FACTORED_VT" in os.environ:
        raise AssertionError("LILAC_FACTORED_VT is set: the main path runs `auto`")
    t0 = time.time()
    plan_d = FactoredNPBPlan("D", dtype="df64", device=DEVICE)
    build_s = time.time() - t0
    V = plan_d.A.V
    if (plan_d.kernel != "factored_routed_df" or plan_d.factored_vt != "adj"
            or plan_d.A.VT is not None or not isinstance(V, rs.RoutedMatHierP)):
        raise AssertionError(
            f"class D plan is {plan_d.kernel} / {plan_d.factored_vt} / {type(V).__name__}")
    emit({"phase": "plan", "class": "D", "factored_vt": "adj",
          "build_s": round(build_s, 2), "m": V.m, "bl": V.bl,
          "gmax": max(len(mt[1]) for g in V.groups
                      for mt in g.pass_meta if mt[0] == "butterfly"),
          "nets": len(V.chunks), "groups": [len(g.net_ids) for g in V.groups],
          "passes_per_direction": _pass_census(V),
          "unperm": V.unperm is not None,
          "plan_bytes_on_card": rs.plan_bytes(V),
          "device_bytes_allocated": torch.cuda.memory_allocated()})
    return plan_d


def build_plan_c():
    """Class C's plan through the entry point (auto = factored_vt=plan)."""
    from lilac_tpu_torch.plan import FactoredNPBPlan

    t0 = time.time()
    plan_c = FactoredNPBPlan("C", dtype="df64", device=DEVICE)
    if plan_c.kernel != "factored_routed_df" or plan_c.factored_vt != "plan":
        raise AssertionError(f"class C plan is {plan_c.kernel} / {plan_c.factored_vt}")
    emit({"phase": "plan", "class": "C", "build_s": round(time.time() - t0, 2),
          "m": plan_c.A.V.m, "nets": [len(plan_c.A.V.chunks), len(plan_c.A.VT.chunks)],
          "stages": [len(plan_c.A.V.kinds), len(plan_c.A.VT.kinds)],
          "mask_planes": list(plan_c.A.V.masks.shape)})
    return plan_c


# ---------------------------------------------------------------------------
# SparseBench: the golden protocol, and the timed BiCG benchmark through the
# single-table (size 40) and hierarchical (size 160) routed plans
# ---------------------------------------------------------------------------

SB_REF_LOG_160 = {"its": -100, "residual": 1.770e4, "true_residual_rel_gap": 4.11e-15}
SB_HIST_TOL = 1e-6  # hist is f32 in both packages
# BiCG on big_gen's nonsymmetric matrices does not converge: two runs that
# are equal in exact arithmetic agree to f32 rounding over the first 30 or
# so norms, then a near-breakdown amplifies the rounding (size 40: up to a
# factor 8 around iteration 60, back to 1e-7 by iteration 80). Histories
# are held to each other over their first SB_HIST_FIRST norms.
SB_HIST_FIRST = 10


def _sb_golden() -> dict:
    """run_case on all 20 GOLDEN rows (sizes 10 and 20, f64 on the card):
    iterations exact, residual within 5% (Scripts/validate.pl). Then the
    line-ILU cases (precond 4, structure 1, size 10): the preconditioner on
    one vector against reference_line_ilusolve to 1e-12 relative, and the
    solve itself finite."""
    from lilac_tpu_torch.generate import sparsebench_gen as gen
    from lilac_tpu_torch.solvers.line_ilu import LineILU, reference_line_ilusolve
    from lilac_tpu_torch.workloads import sparsebench as sb

    t0 = time.time()
    worst, failed = 0.0, []
    for key in sorted(sb.GOLDEN):
        r = sb.run_case(*key, device=DEVICE)
        worst = max(worst, r.residual_rel_err)
        if not r.validated:
            failed.append((key, r.iterations, r.residual))
    if failed:
        raise AssertionError(f"golden rows off the reference: {failed}")
    rng = np.random.default_rng(31)
    line_ilu = {}
    for sym in ("s", "u"):
        bands = gen.regular_system(10, sym=sym == "s")["bands"]
        x = rng.standard_normal(1000)
        got = LineILU.build(bands, device=DEVICE).apply(
            torch.as_tensor(x, device=DEVICE)).cpu().numpy()
        want = reference_line_ilusolve(bands, x)
        rel = float(np.abs(got - want).max() / np.abs(want).max())
        r = sb.run_case(sym, 10, 1, 4, device=DEVICE)
        line_ilu[sym] = {"apply_rel_err": rel, "iterations": r.iterations,
                         "residual": r.residual}
        if not rel <= 1e-12 or not np.isfinite(r.residual) or r.iterations != 10:
            raise AssertionError(f"line-ILU {sym}: {line_ilu[sym]}")
    return {"golden_rows": len(sb.GOLDEN), "validated": len(sb.GOLDEN),
            "max_residual_rel_err": worst, "line_ilu_size10": line_ilu,
            "wall_s": round(time.time() - t0, 1)}


def _sb_dots(its: int) -> int:
    """The df64 dots of one BiCG solve that ended at `its` (solvers/bicg.py):
    three in each iteration run whole, the norm alone in a converged last
    one, and the final norm."""
    return 3 * -its + 1 if its < 0 else 3 * (its - 1) + 2


def _sb_dfops(its: int) -> dict:
    """dfops's launches by entry in one df64 BiCG solve that ended at `its`
    (solvers/bicg.py): the start's residual (sub); in each iteration the
    norm (sqrt) and the threshold (mul); in each run whole the three
    updates (three mul, three sub) and alpha (div), and after the first
    beta (div) and the two directions (two mul, two add); the final norm
    (sqrt). A converged last iteration stops after its threshold."""
    run = abs(its)
    whole = run if its < 0 else max(run - 1, 0)
    later = max(whole - 1, 0)
    return {"add": 2 * later, "sub": 1 + 3 * whole, "mul": run + 3 * whole + 2 * later,
            "div": whole + later, "sqrt": run + 1}


def _sb_run(size: int, kernel: str, env: dict | None = None):
    """sparsebench.benchmark(size) in df64 through `kernel`, launch counts
    set to 0 just before and read just after; returns (result, counts).
    dfdot's launches are held to the dots of its two solves (the warm-up
    and the timed one), each two launches where the library splits the
    tree, one where it does not; dfops's, entry by entry, to _sb_dfops of
    the two solves."""
    from lilac_tpu_torch.kernels import dfdot as kd
    from lilac_tpu_torch.kernels import dfmulred as dfk
    from lilac_tpu_torch.kernels import dfops
    from lilac_tpu_torch.kernels import routed as rd
    from lilac_tpu_torch.workloads import sparsebench as sb

    _reset_hier_counts(rd, dfk)
    res = _with_env(env or {}, lambda: sb.benchmark(
        size, kernel=kernel, dtype="df64", device=DEVICE))
    counts = {**_hier_counts(rd), "routed_apply": rd.routed_apply.launches,
              "routed_apply_t": rd.routed_apply_t.launches,
              "dfmulred": dfk.dfmulred.launches, "dfdot": kd.dfdot.launches,
              "dfops": sum(dfops.launches.values())}
    if not np.isfinite(res.hist).all() or not res.validated:
        raise AssertionError(f"sparsebench {size} {kernel}: not validated: {res}")
    depth = kd.kernel_depth(res.n, kd.device_sms(torch.cuda.current_device()))
    want = 2 * _sb_dots(res.iterations) * (2 if depth else 1)
    if counts["dfdot"] != want:
        raise AssertionError(f"sparsebench {size} {kernel}: dfdot launched "
                             f"{counts['dfdot']} times in two solves ({want} expected)")
    want = {k: 2 * v for k, v in _sb_dfops(res.iterations).items()}
    if dfops.launches != want:
        raise AssertionError(f"sparsebench {size} {kernel}: dfops launched "
                             f"{dfops.launches} in two solves ({want} expected)")
    return res, counts


def _sb_line(res, counts, **extra) -> dict:
    return {"size": res.size, "n": res.n, "nnz": res.nnz, "kernel": res.kernel,
            "iterations": res.iterations, "time_s": res.time_s,
            "mflop_rate": res.mflop_rate, "residual": res.residual,
            "true_residual_rel_gap": res.true_residual_rel_gap,
            "validated": res.validated, "build_s": round(res.build_s, 2),
            "hist_first": [float(h) for h in res.hist[:10]],
            "launches": {k: v for k, v in counts.items() if v}, **extra}


def _hist_rel(a, b, k: int) -> float:
    a, b = np.asarray(a[:k], np.float64), np.asarray(b[:k], np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


def _sb_single_table_checks(plan, rng) -> dict:
    """K1, K11 and K2 on the size-40 plan's own masks and values, bit for
    bit against their plain versions: a df64 pair forwards and in reverse,
    and the whole product's K2 sums."""
    from lilac_tpu_torch.kernels import dfmulred as dfk
    from lilac_tpu_torch.kernels import routed as rd
    from lilac_tpu_torch.kernels import routed_spmv as rs

    A = plan.A
    B, _, R, _ = A.masks.shape
    xh = torch.as_tensor(rng.standard_normal(R * 128).astype(np.float32),
                         device=DEVICE).view(R, 128)
    xs = [xh, (xh * 2.0 ** -25).contiguous()]
    got = rd.routed_apply(xs, A.masks, A.kinds, A.dists)
    if not all(_bits_equal(g, w) for g, w in zip(
            got, rd.routed_apply_plain(xs, A.masks, A.kinds, A.dists))):
        raise AssertionError("routed_apply != plain on the size-40 plan")
    us = _adj_planes(rng, (B, R, 128), np.float32, 2, True)
    got_t = rd.routed_apply_t(us, A.masks, A.kinds, A.dists, dfpair=True)
    if not all(_bits_equal(g, w) for g, w in zip(
            got_t, rd.routed_apply_t_plain(us, A.masks, A.kinds, A.dists, dfpair=True))):
        raise AssertionError("routed_apply_t != plain on the size-40 plan")
    table = rs._single_table_k2(A.chunks, A.m)
    vflat = A.vals.reshape(-1, 2)
    ph = torch.as_tensor(rng.standard_normal(vflat.shape[0]).astype(np.float32),
                         device=DEVICE)
    args = (vflat[:, 0], vflat[:, 1], ph, (ph * 2.0 ** -26).contiguous(), table)
    if not all(_bits_equal(g, w) for g, w in zip(
            dfk.dfmulred_chunks(*args), dfk.dfmulred_chunks_plain(*args))):
        raise AssertionError("dfmulred_chunks != plain on the size-40 product")
    return {"m": A.m, "nets": B, "stages": len(A.kinds), "k2_chunks": len(A.chunks)}


def _sb_hier_checks(plan, rng, kernels: dict) -> dict:
    """K3-K6 and K7-K10 on the size-160 plan's largest packed group, every
    pass of its schedule bit for bit against the plain version (forwards
    on a df64 pair, in reverse on a df64 pair a net), the first pass of
    each kind timed; K2 on that group's whole product bit for bit."""
    from lilac_tpu_torch.kernels import dfmulred as dfk
    from lilac_tpu_torch.kernels import routed as rd
    from lilac_tpu_torch.kernels import routed_spmv as rs

    P = plan.A
    grp = max(P.groups, key=lambda g: len(g.net_ids))
    N = len(grp.net_ids)
    xh = torch.as_tensor(rng.standard_normal(P.shape[1]).astype(np.float32),
                         device=DEVICE)
    planes = (_plane(xh, P.m), _plane((xh * 2.0 ** -25).contiguous(), P.m))
    timed: dict = {}
    _walk_schedule(rd, planes, grp.pass_meta, grp.pass_masks, P.bl, True,
                   f"sparsebench 160 plan, group of {N} nets", timed, 5)
    us = _adj_planes(rng, (N, P.m // 128, 128), np.float32, 2, True)
    _walk_schedule_t(rd, us, grp.pass_meta, grp.pass_masks, P.bl, True,
                     f"sparsebench 160 plan, group of {N} nets, reversed", timed, 5)
    del planes, us
    gi = next(i for i, g in enumerate(P.groups) if g is grp)
    table = rs._hier_k2(P.chunks, tuple(g.net_ids for g in P.groups), P.m)[gi]
    ph = torch.as_tensor(rng.standard_normal(N * P.m).astype(np.float32), device=DEVICE)
    args = (grp.vals[0].reshape(-1), grp.vals[1].reshape(-1), ph,
            (ph * 2.0 ** -26).contiguous(), table)
    if not all(_bits_equal(g, w) for g, w in zip(
            dfk.dfmulred_chunks(*args), dfk.dfmulred_chunks_plain(*args))):
        raise AssertionError("dfmulred_chunks != plain on the size-160 group product")
    k2 = _k2_product(dfk, args, "sparsebench 160 group")
    del ph, args
    for name, row in timed.items():
        kernels.setdefault(name, {"name": name})["sb160"] = {
            k: row[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms", "shape")}
    kernels.setdefault("dfmulred", {"name": "dfmulred"})["sb160"] = {
        k: k2[k] for k in ("ms", "plain_ms", "bound_ms", "chunks", "rows")}
    return {"group_nets": N, "groups": [len(g.net_ids) for g in P.groups],
            "m": P.m, "bl": P.bl, "passes_checked": len(grp.pass_meta),
            "passes_per_direction": _pass_census(P), "unperm": P.unperm is not None,
            "timed_ms": {k: v["ms"] for k, v in timed.items()}, "k2_group_ms": k2["ms"]}


def _host_bicg_hist(ip, ix, dv, n: int, nit: int) -> np.ndarray:
    """An independent f64 replica of BiCG on the host (scipy CSR, Aᵀ from
    scipy), in the reference's update order (iter.f:18-104: r = A x - b,
    rl = r, p = z + beta p, alpha = rr / (pl, A p)), b = 1, x0 = 0, no
    preconditioner: the first `nit` residual norms."""
    import scipy.sparse as sp

    A = sp.csr_matrix((dv, ix, ip), shape=(n, n))
    At = A.T.tocsr()
    x = np.zeros(n)
    r = A @ x - np.ones(n)
    rl = r.copy()
    p = pl = None
    rr = 1.0
    hist = []
    for it in range(nit):
        hist.append(np.linalg.norm(r))
        rr_new = float(r @ rl)
        if it == 0:
            p, pl = r.copy(), rl.copy()
        else:
            beta = rr_new / rr
            p, pl = beta * p + r, beta * pl + rl
        ap, apl = A @ p, At @ pl
        alpha = rr_new / float(pl @ ap)
        x -= alpha * p
        r = r - alpha * ap
        rl = rl - alpha * apl
        rr = rr_new
    return np.asarray(hist)


def _bench_cli(bench: str, size: str, *impl: str) -> dict:
    """`python -m lilac_tpu_torch.bench run --bench <bench> --size <size>
    [--impl <impl>] --runs 1`, its CSV row appended to a temporary file."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "bench.csv")
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", "lilac_tpu_torch.bench", "run", "--bench", bench,
             "--size", size, *(("--impl",) + impl if impl else ()), "--runs", "1",
             "--out", out], cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"bench run {bench} failed: {proc.stderr[-2000:]}")
        with open(out) as f:
            rows = [ln.strip().split(",") for ln in f if ln.strip()]
    if len(rows) != 1 or rows[0][:4] != ["gpu", bench, impl[0] if impl else "auto", size] \
            or not float(rows[0][4]) > 0:
        raise AssertionError(f"bench run {bench} wrote {rows}")
    return {"csv_row": rows[0], "wall_s": round(time.time() - t0, 1)}


def phase_sparsebench(kernels: dict) -> dict:
    """SparseBench on the card: the golden protocol; the timed BiCG
    benchmark at size 40 (n = 64 000, one single-table routed plan; adj =
    K1, K2, K11, then plan = K1, K2 on two plans); at size 160 (n =
    4 096 000, 27 466 726 entries, df64, maxit 100, rtol 1e-6) through ONE
    hierarchical routed plan run forwards (K3-K6, K2) and in reverse
    (K7-K10) as `auto` resolves it, held to an f64 host replica of BiCG over
    its first 10 norms; the same size through the gather path the selector
    picks; and the bench CLI at size 40."""
    t_phase = time.time()
    with ThreadPoolExecutor(1) as pool:
        # the f64 host replica of size 160 (generation, relabel, 10 BiCG
        # iterations in scipy: about 27 s) runs beside the card's work
        replica = pool.submit(_sb160_replica)
        return _sparsebench(kernels, t_phase, replica)


def _sb160_replica() -> tuple:
    """The size-160 matrix as the routed run relabels it, and its f64 host
    replica's first SB_HIST_FIRST residual norms, with the seconds taken."""
    from lilac_tpu_torch.formats.convert import length_relabel_csr
    from lilac_tpu_torch.generate.random_crs import random_crs

    t0 = time.time()
    ip, ix, dv, shp = random_crs(160, seed=0)
    ip, ix, dv, _, _ = length_relabel_csr(ip, ix, dv, shp)
    return _host_bicg_hist(ip, ix, dv, shp[0], SB_HIST_FIRST), time.time() - t0


def _sparsebench(kernels: dict, t_phase: float, replica) -> dict:
    from lilac_tpu_torch.kernels import routed_spmv as rs

    line: dict = {"phase": "sparsebench", "golden": _sb_golden()}
    emit({"phase": "sparsebench_golden", **line["golden"]})
    rng = np.random.default_rng(37)

    # --- size 40: one single-table plan, A^T p by K11 (adj) or a second plan
    r40 = {}
    for mode in ("adj", "plan"):
        res, counts = _sb_run(40, "routed", {"LILAC_SB_TRANSPOSE": mode})
        r40[mode] = (res, counts)
        emit({"phase": "sparsebench_run", "sb_transpose": mode, **_sb_line(res, counts)})
        if res.kernel != "routed_df" or (res.plans[1] is None) != (mode == "adj"):
            raise AssertionError(f"size 40 {mode}: {res.kernel}, plan_t {res.plans[1]}")
        k11 = counts["routed_apply_t"]
        if not (counts["routed_apply"] > 0 and counts["dfmulred"] > 0) \
                or (k11 > 0) != (mode == "adj"):
            raise AssertionError(f"size 40 {mode}: launches {counts}")
    (ra, ca), (rp, cp) = r40["adj"], r40["plan"]
    if ra.iterations != rp.iterations:
        raise AssertionError(f"size 40: its {ra.iterations} (adj) != {rp.iterations} (plan)")
    hist40 = _hist_rel(ra.hist, rp.hist, SB_HIST_FIRST)
    if not hist40 <= SB_HIST_TOL:
        raise AssertionError(f"size 40: adj and plan histories differ by {hist40:.3e}")
    line["size40"] = {"iterations": ra.iterations, "hist_max_rel_diff": hist40,
                      "hist_max_rel_diff_all": _hist_rel(ra.hist, rp.hist, abs(ra.iterations)),
                      "time_s": {"adj": ra.time_s, "plan": rp.time_s},
                      "kernels_checked": _sb_single_table_checks(ra.plans[0], rng)}
    for name in ("routed_apply", "routed_apply_t", "dfmulred"):
        kernels.setdefault(name, {"name": name})["launches_sb40_adj"] = ca[name]
    del r40, ra, rp
    torch.cuda.empty_cache()

    # --- size 160: the slice's path at full width, one hierarchical plan
    res, counts = _sb_run(160, "routed")
    plan = res.plans[0]
    if res.kernel != "routed_hier_df" or res.plans[1] is not None \
            or not isinstance(plan.A, rs.RoutedMatHierP):
        raise AssertionError(f"size 160: {res.kernel} / plan_t {res.plans[1]}")
    if res.n != 160 ** 3 or res.iterations != SB_REF_LOG_160["its"]:
        raise AssertionError(f"size 160: n {res.n}, its {res.iterations}")
    for name in FWD_D + ADJ_D + ("dfmulred",):
        if counts[name] <= 0:
            raise AssertionError(f"size 160: {name} not launched: {counts}")
    if counts["routed_apply"] or counts["routed_apply_t"]:
        raise AssertionError(f"size 160 went through a single-table kernel: {counts}")
    for name in FWD_D + ADJ_D + ("bigshift_apply_b", "bigshift_apply_bt", "dfmulred"):
        kernels.setdefault(name, {"name": name})["launches_sb160"] = counts[name]
    dfdot_row = kernels.setdefault("dfdot", {"name": "dfdot", "launches": 0})
    dfdot_row["launches_sb160"] = counts["dfdot"]
    dfdot_row["launches"] += counts["dfdot"]
    dfops_row = kernels.setdefault("dfops", {"name": "dfops", "launches": 0})
    dfops_row["launches_sb160"] = counts["dfops"]
    dfops_row["launches"] += counts["dfops"]
    t0 = time.time()
    host, replica_s = replica.result()
    replica_wait_s = time.time() - t0
    rel160 = _hist_rel(res.hist, host, SB_HIST_FIRST)
    routed = _sb_line(
        res, counts, plan_bytes_on_card=rs.plan_bytes(plan.A),
        device_bytes_allocated=torch.cuda.memory_allocated(),
        reference_log=SB_REF_LOG_160, host_replica_hist=[float(h) for h in host],
        host_replica_max_rel_diff=rel160, host_replica_s=round(replica_s, 1),
        host_replica_wait_s=round(replica_wait_s, 1),
        kernels_checked=_sb_hier_checks(plan, rng, kernels))
    emit({"phase": "sparsebench_run", "sb_transpose": "auto", **routed})
    if not rel160 <= SB_HIST_TOL:
        raise AssertionError(f"size 160: first norms off the host replica by {rel160:.3e}")
    line["size160_routed"] = {k: routed[k] for k in (
        "iterations", "time_s", "mflop_rate", "residual", "true_residual_rel_gap",
        "build_s", "plan_bytes_on_card", "host_replica_max_rel_diff")}
    hist_routed = res.hist
    del res, plan
    torch.cuda.empty_cache()

    # --- size 160 through the gather path the selector picks (A^T: its own plan)
    res_g, counts_g = _sb_run(160, "auto")
    rel_g = _hist_rel(res_g.hist, hist_routed, SB_HIST_FIRST)
    gather = _sb_line(res_g, counts_g, hist_max_rel_diff_vs_routed=rel_g,
                      hist_max_rel_diff_all=_hist_rel(res_g.hist, hist_routed, 100),
                      transposed_kernel=res_g.plans[1].kernel)
    emit({"phase": "sparsebench_run", "sb_transpose": "auto", **gather})
    if res_g.kernel != "xla_sell_df" or res_g.iterations != line["size160_routed"]["iterations"]:
        raise AssertionError(f"size 160 gather: {res_g.kernel}, its {res_g.iterations}")
    if not rel_g <= SB_HIST_TOL:
        raise AssertionError(f"size 160: gather and routed histories differ by {rel_g:.3e}")
    line["size160_gather"] = {k: gather[k] for k in (
        "kernel", "iterations", "time_s", "mflop_rate", "true_residual_rel_gap",
        "build_s", "transposed_kernel")}
    del res_g
    torch.cuda.empty_cache()

    line["cli"] = _bench_cli("sparsebench", "40", "routed")
    line["wall_s"] = round(time.time() - t_phase, 1)
    emit(line)
    return line


# the port's own CUDA kernels, by the names of their __global__ functions;
# every other kernel in a trace is PyTorch's (the plain-torch glue)
PORT_KERNELS = ("hier_", "adj_", "dfmulred", "inner::", "tile_pass", "routed_stage")


def _trace(fn):
    """Run fn under torch.profiler: (wall seconds, {kernel: (count, us)},
    device busy seconds). Copies and sets are device work but no kernel
    launches: they count in busy, the union of every device operation's
    interval, and are left out of the kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels, spans = {}, []
    for ev in prof.events():
        if "cuda" not in str(getattr(ev, "device_type", "")).lower():
            continue
        spans.append((ev.time_range.start, ev.time_range.end))
        if not ev.name.startswith(("Memcpy", "Memset")):
            c, us = kernels.get(ev.name, (0, 0.0))
            kernels[ev.name] = (c + 1, us + ev.device_time)
    busy_us, reach = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > reach:
            busy_us += b - max(a, reach)
            reach = b
    return wall, kernels, busy_us * 1e-6


def _summary(wall, kernels, busy, top=20):
    rows = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:top]
    return {
        "wall_ms": wall * 1e3,
        "device_busy_ms": busy * 1e3,
        "device_idle_share": max(0.0, 1.0 - busy / wall) if wall else None,
        "launches": sum(c for c, _ in kernels.values()),
        "top_by_device_time": [
            {"kernel": name[:90], "count": c, "ms": us / 1e3} for name, (c, us) in rows],
    }


def phase_sb_profile(size: int = 160) -> dict:
    """Opt-in: where the size-160 BiCG spends its time. For the routed plan
    (adj) and the gather path, torch.profiler traces one A p, one A^T p and
    3 BiCG iterations (paused and resumed through bicg_solve's state after
    2 warm-up iterations), beside the untraced wall of those 3 iterations;
    each trace's device time is split between the port's kernels and
    PyTorch's (the df64 glue and vector ops)."""
    from lilac_tpu_torch.solvers.algebra import get_algebra
    from lilac_tpu_torch.solvers.bicg import bicg_solve
    from lilac_tpu_torch.workloads import sparsebench as sb

    out = {"phase": "sb_profile", "size": size}
    for kernel in ("routed", "auto"):
        plan, plan_t, n, _ = sb.build_bench_plans(size, kernel=kernel, dtype="df64",
                                                  device=DEVICE)
        alg = get_algebra("df64", device=DEVICE)
        As = (plan.A,) if plan_t is None else (plan.A, plan_t.A)
        mv_t = ((lambda A_, v: plan.matvec_t_with(A_[0], v)) if plan_t is None
                else (lambda A_, v: plan_t.matvec_with(A_[1], v)))
        args = (lambda A_, v: plan.matvec_with(A_[0], v), mv_t, alg, As,
                plan.vec_in(np.ones(n)), plan.vec_in(np.zeros(n)))
        *_, state = bicg_solve(*args, maxit=100, stop_at=2)
        p = state[3]

        def iterations():
            bicg_solve(*args, maxit=100, state=state, stop_at=5)

        iterations()  # warm-up of the traced window
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        iterations()
        torch.cuda.synchronize()
        untraced = time.perf_counter() - t0
        row = {"kernel": plan.kernel, "transpose": "adj" if plan_t is None else plan_t.kernel,
               "three_iterations_untraced_ms": untraced * 1e3}
        for what, fn in (("A_p", lambda: args[0](As, p)), ("At_p", lambda: mv_t(As, p)),
                         ("three_iterations", iterations)):
            fn()
            wall, ks, busy = _trace(fn)
            s = _summary(wall, ks, busy, top=12)
            port_us = sum(us for name, (_, us) in ks.items()
                          if any(k in name for k in PORT_KERNELS))
            s["port_kernels_ms"] = port_us / 1e3
            s["torch_kernels_ms"] = s["device_busy_ms"] - port_us / 1e3
            row[what] = s
        out[kernel] = row
        del plan, plan_t, state, p, args, As
        torch.cuda.empty_cache()
    emit(out)
    return out


# ---------------------------------------------------------------------------
# The graph workloads: PageRank and BFS on power-law graphs in f32, through
# one routing table (n = 200 000) and the hierarchical plans (graph-scale's
# n = 1 000 000, K3-K6 on one plane of 4-byte words; n = 300 000 unrelabeled,
# whose un-permute network runs K3u-K6u)
# ---------------------------------------------------------------------------

GRAPH_N = 1_000_000  # graph-scale's defaults (lilac_tpu/bench/__main__.py:38-40)
GRAPH_DEG = 16.0
PR_ITERS = 128
PR_RUNS = 2
BFS_SOURCES = 16
GRAPH_SMALL_N = 200_000  # under 2^18 columns: one routing table
GRAPH_UNPERM_N = 300_000
PR_X_L1 = 1e-3  # f32 x against the f64 replica, L1 relative
PR_ERR_REL = 1e-2  # the last step norm against the replica's, relative
PR_RELABEL_TOL = dict(rtol=2e-4, atol=1e-7)  # tests/test_graph.py:76, 91
# the reference's own run at n = 1e6 (tools/out5/capture_graphs.log), an
# accuracy record only
PR_REF_LOG = {"n": 1_000_000, "nnz": 13_308_062, "error": 1.240e-05}
FWD_HIER = ("routed_apply_sliced_b", "butterfly_apply_b", "window_shift_apply_b")


def _pagerank_replica(g, iters: int, d: float = 0.85, seed: int = 0) -> tuple:
    """An f64 scipy replica of `iters` PageRank iterations in the
    reference's order (main.cpp:101-155) from the benchmark's x0: (x, the
    last step norm). Its column scaling is scipy's own, not the port's."""
    import scipy.sparse as sp

    ip, ix, data, shape = g
    A = sp.csr_matrix((np.asarray(data, np.float64), ix, ip), shape=shape)
    colsum = np.asarray(A.sum(axis=0)).ravel()
    scale = np.ones_like(colsum)
    np.divide(1.0, colsum, out=scale, where=colsum != 0.0)  # empty columns stay
    A = sp.csr_matrix(A @ sp.diags(scale * d))
    n = shape[0]
    x = np.random.default_rng(seed).random(n)
    x /= x.sum()
    err = 0.0
    for _ in range(iters):
        y = A @ x + (1.0 - d) * (x.sum() / n)
        err = float(np.sqrt(((y - x) ** 2).sum()))
        x = y
    return x, err


def _graph_counts(rd) -> dict:
    return {**_hier_counts(rd), "routed_apply": rd.routed_apply.launches}


def _plan_info(plan) -> dict:
    """What a graph plan holds on the card: its kernel and, for a routed
    plan, its table width, nets, row chunks and bytes."""
    from lilac_tpu_torch.kernels import routed_spmv as rs

    A = plan.A
    info = {"kernel": plan.kernel}
    if isinstance(A, rs.RoutedMatHierP):
        info.update(m=A.m, bl=A.bl, nets=len(A.chunks),
                    chunks=sum(len(c) for c in A.chunks),
                    groups=[len(g.net_ids) for g in A.groups],
                    passes_a_product=_pass_census(A), unperm=A.unperm is not None,
                    unperm_passes=len(A.unperm.pass_meta) if A.unperm else 0,
                    plan_bytes_on_card=rs.plan_bytes(A))
    elif isinstance(A, rs.RoutedMat):
        info.update(m=A.m, nets=len(A.chunks), stages=len(A.kinds),
                    inv_perm=A.inv_perm is not None,
                    plan_bytes_on_card=A.masks.numel() * A.masks.element_size()
                    + A.vals.numel() * A.vals.element_size())
    return info


def _pagerank_on_card(g, kernel: str, replica, iters: int = PR_ITERS,
                      runs: int = PR_RUNS, **kw) -> tuple:
    """pagerank.run on the card, launch counts set to 0 just before and
    read just after; x and the last step norm held to the f64 replica.
    Returns (result, line, counts)."""
    from lilac_tpu_torch.kernels import dfmulred as dfk
    from lilac_tpu_torch.kernels import routed as rd
    from lilac_tpu_torch.workloads import pagerank

    _reset_hier_counts(rd, dfk)
    r = pagerank.run(*g, iters=iters, runs=runs, kernel=kernel, device=DEVICE, **kw)
    counts = _graph_counts(rd)
    x_ref, err_ref = replica
    n, nnz = g[3][0], len(g[1])
    l1 = float(np.abs(r.x - x_ref).sum() / np.abs(x_ref).sum())
    err_rel = abs(r.error - err_ref) / err_ref
    products = (runs + 1) * iters  # the untimed run and the timed ones
    line = {"workload": "pagerank", "n": n, "nnz": nnz, "kernel_arg": kernel, **kw,
            **_plan_info(r.plan), "build_s": round(r.build_s, 2), "iters": iters,
            "times_s": r.times_s, "gnnz_s": iters * nnz / min(r.times_s) / 1e9,
            "error": r.error, "replica_error": err_ref, "error_rel_diff": err_rel,
            "x_l1_rel_diff": l1, "x_sum": float(r.x.sum()),
            "launches": {k: v for k, v in counts.items() if v},
            "launches_a_product": {k: v / products for k, v in counts.items() if v}}
    emit({"phase": "graphs_run", **line})
    if r.x.shape != (n,) or not np.isfinite(r.x).all() or not l1 <= PR_X_L1 \
            or not err_rel <= PR_ERR_REL:
        raise AssertionError(f"pagerank n={n} {kernel}: x {l1:.3e}, error {err_rel:.3e} "
                             "off the f64 replica")
    return r, line, counts


def _bfs_on_card(g, kernel: str, oracle: dict) -> tuple:
    """run_benchmark(runs=16) on the card, counts as above; every source's
    distances equal to bfs_oracle (filled into `oracle` on first use)."""
    from lilac_tpu_torch.kernels import dfmulred as dfk
    from lilac_tpu_torch.kernels import routed as rd
    from lilac_tpu_torch.workloads import bfs

    _reset_hier_counts(rd, dfk)
    r = bfs.run_benchmark(*g, runs=BFS_SOURCES, kernel=kernel, device=DEVICE)
    counts = _graph_counts(rd)
    t0 = time.time()
    bad = []
    for s, d in zip(r.sources, r.distances):
        if int(s) not in oracle:
            oracle[int(s)] = bfs.bfs_oracle(*g, int(s))
        if not np.array_equal(d, oracle[int(s)]):
            bad.append(int(s))
    n, nnz = g[3][0], len(g[1])
    line = {"workload": "bfs", "n": n, "nnz": nnz, "kernel_arg": kernel,
            **_plan_info(r.plan), "build_s": round(r.build_s, 2), "time_s": r.time_s,
            "sources": [int(s) for s in r.sources],
            "levels": [int(d.max()) for d in r.distances],
            "reached": [int((d > 0).sum()) for d in r.distances],
            "oracle_s": round(time.time() - t0, 1), "distances_equal_oracle": not bad,
            "launches": {k: v for k, v in counts.items() if v}}
    emit({"phase": "graphs_run", **line})
    if bad:
        raise AssertionError(f"bfs n={n} {kernel}: sources {bad} differ from bfs_oracle")
    return r, line, counts


def _f32_plane(rng, n: int, m: int) -> torch.Tensor:
    """A random f32 vector of n entries (distinct values, so that a misrouted
    word shows) zero-padded to one [m // 128, 128] plane."""
    x = torch.as_tensor(rng.standard_normal(n).astype(np.float32), device=DEVICE)
    return _plane(x, m)


def _record_timed(kernels: dict, timed: dict, key: str) -> dict:
    """Each timed pass row into its kernel's entry under `key`; the summary."""
    for name, row in timed.items():
        kernels.setdefault(name, {"name": name})[key] = {
            k: row[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms", "shape",
                                "bytes") + (("launch",) if "launch" in row else ())}
    return {k: {"ms": v["ms"], "bound_ms": v["bound_ms"],
                "share_of_bound": v["bound_ms"] / v["ms"],
                "library_ms": v["library_ms"]} for k, v in timed.items()}


def _graph_pass_checks(plan, kernels: dict | None, what: str) -> dict:
    """Every pass of every packed group of a 1M graph plan, on one random
    f32 plane, bit for bit against its plain version. With `kernels`, the
    first pass of each kind is also timed beside its byte bound and its
    composed gather."""
    from lilac_tpu_torch.kernels import routed as rd

    P = plan.A
    x = _f32_plane(np.random.default_rng(41), P.shape[1], P.m)
    timed: dict | None = {} if kernels is not None else None
    for grp in P.groups:
        _walk_schedule(rd, (x,), grp.pass_meta, grp.pass_masks, P.bl, True,
                       f"{what}, group of {len(grp.net_ids)} nets, f32", timed, 10)
    out = {"groups_walked": [len(g.net_ids) for g in P.groups],
           "passes_checked": sum(len(g.pass_meta) for g in P.groups)}
    if kernels is not None:
        out["timed"] = _record_timed(kernels, timed, "graph_f32")
    return out


def _unperm_pass_checks(plan, kernels: dict) -> dict:
    """Every pass of an unrelabeled plan's un-permute network (one net,
    K3u-K6u) on one random f32 plane, bit for bit against its plain
    version; the first pass of each kind timed beside its byte bound."""
    from lilac_tpu_torch.kernels import routed as rd

    P = plan.A
    U = P.unperm
    x = _f32_plane(np.random.default_rng(43), P.m_out, P.m_out)
    timed: dict = {}
    _walk_schedule(rd, (x,), U.pass_meta, U.pass_masks, P.bl, False,
                   "pagerank 300k un-permute network, f32", timed, 10)
    return {"m_out": P.m_out, "passes_checked": len(U.pass_meta),
            "kinds": [mt[0] for mt in U.pass_meta],
            "timed": _record_timed(kernels, timed, "unperm_f32")}


def _k1_plan_check(plan, rng, what: str) -> dict:
    """K1 on a single-table graph plan's own routing tables, one random f32
    plane, bit for bit against its plain version."""
    from lilac_tpu_torch.kernels import routed as rd

    A = plan.A
    x = _f32_plane(rng, A.m, A.m)
    got = rd.routed_apply([x], A.masks, A.kinds, A.dists)
    torch.cuda.synchronize()
    want = rd.routed_apply_plain([x], A.masks, A.kinds, A.dists)
    if not _bits_equal(got[0], want[0]):
        raise AssertionError(f"{what}: routed_apply != routed_apply_plain in f32 "
                             f"{_bits_diff(got, want)}")
    return {"m": A.m, "nets": A.masks.shape[0], "stages": len(A.kinds),
            "bit_identical_to_plain": True}


def _add_launches(kernels: dict, key: str, counts_list) -> None:
    for counts in counts_list:
        for name, v in counts.items():
            row = kernels.setdefault(name, {"name": name})
            row[key] = row.get(key, 0) + v


def _hier_nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v and k != "routed_apply"}


def phase_graphs(kernels: dict) -> dict:
    """PageRank and BFS (generate/graphs.py, workloads/pagerank.py,
    workloads/bfs.py) on the card in f32:

    * n = 200 000 (one routing table): PageRank 128 iterations through
      `routed` (relabeled, K1), `auto` (routed too: a plan declared for many
      products on the card; unrelabeled) and `xla_sell` (gather), each held
      to an f64 scipy replica of the same iterations; BFS from 16 sources,
      routed and auto, every distance vector equal to bfs_oracle; the bench
      CLI's pagerank row at size 40;
    * n = 1 000 000, graph-scale's default: the same through ONE f32
      hierarchical routed plan (K3-K5, K6 where the plan has block-aligned
      shifts) and through the gather path `auto` picks, every pass of the
      PageRank plan's first group bit for bit and timed on one f32 plane;
    * n = 300 000 (hierarchical), PageRank unrelabeled (its un-permute
      network runs K3u-K6u) against the relabeled run."""
    from lilac_tpu_torch.generate.graphs import powerlaw_graph

    t_phase = time.time()
    out: dict = {"phase": "graphs"}

    # --- one routing table
    t0 = time.time()
    g = powerlaw_graph(GRAPH_SMALL_N, GRAPH_DEG, seed=0)
    gs = powerlaw_graph(GRAPH_SMALL_N, GRAPH_DEG, seed=0, symmetric=True)
    replica = _pagerank_replica(g, PR_ITERS)
    small = {"gen_and_replica_s": round(time.time() - t0, 1)}
    k1 = []
    rng = np.random.default_rng(47)
    for kernel, want in (("routed", "routed"), ("auto", "routed"), ("xla_sell", "xla_sell")):
        r, line, counts = _pagerank_on_card(g, kernel, replica)
        if r.plan.kernel != want or (want == "routed") != (counts["routed_apply"] > 0):
            raise AssertionError(f"pagerank 200k {kernel}: {r.plan.kernel}, {counts}")
        small[f"pagerank_{kernel}"] = {k: line[k] for k in (
            "kernel", "build_s", "times_s", "error", "x_l1_rel_diff")}
        if want == "routed":
            small[f"pagerank_{kernel}"]["k1_check"] = _k1_plan_check(
                r.plan, rng, f"pagerank 200k {kernel} plan")
        k1.append({"routed_apply": counts["routed_apply"]})
        del r
    oracle: dict = {}
    for kernel in ("routed", "auto"):
        r, line, counts = _bfs_on_card(gs, kernel, oracle)
        if r.plan.kernel != "routed" or counts["routed_apply"] <= 0:
            raise AssertionError(f"bfs 200k {kernel}: {r.plan.kernel}, {counts}")
        small[f"bfs_{kernel}"] = {k: line[k] for k in ("build_s", "time_s", "levels")}
        small[f"bfs_{kernel}"]["k1_check"] = _k1_plan_check(
            r.plan, rng, f"bfs 200k {kernel} plan")
        k1.append({"routed_apply": counts["routed_apply"]})
        del r
    _add_launches(kernels, "launches_graphs_200k", k1)
    # random_crs(40): n = 64 000, 1024 iterations
    small["cli"] = _bench_cli("pagerank", "40")
    out["n200k"] = small
    emit({"phase": "graphs_200k", **small})
    del g, gs, oracle
    torch.cuda.empty_cache()

    # --- graph-scale's n = 1 000 000: the f32 hierarchical plans
    t0 = time.time()
    g = powerlaw_graph(GRAPH_N, GRAPH_DEG, seed=0)
    gen_s = time.time() - t0
    t0 = time.time()
    replica = _pagerank_replica(g, PR_ITERS)
    big = {"gen_s": round(gen_s, 1), "replica_s": round(time.time() - t0, 1),
           "replica_error": replica[1], "reference_log": PR_REF_LOG}
    r, line, counts = _pagerank_on_card(g, "routed", replica)
    if r.plan.kernel != "routed_hier" or r.plan.A.unperm is not None \
            or any(counts[k] <= 0 for k in FWD_HIER) or counts["routed_apply"]:
        raise AssertionError(f"pagerank 1M routed: {r.plan.kernel}, {counts}")
    big["pagerank_routed"] = line
    big["passes"] = _graph_pass_checks(r.plan, kernels, "pagerank 1M plan")
    _add_launches(kernels, "launches_pagerank_1m", [_hier_nonzero(counts)])
    del r
    torch.cuda.empty_cache()
    r, line, counts = _pagerank_on_card(g, "auto", replica)
    _note_auto("pagerank 1M", r.plan)
    if not r.plan.kernel.startswith("xla_") or any(counts.values()):
        raise AssertionError(f"pagerank 1M auto: {r.plan.kernel}, {counts}")
    big["pagerank_auto"] = line
    del r, g, replica
    torch.cuda.empty_cache()

    t0 = time.time()
    gs = powerlaw_graph(GRAPH_N, GRAPH_DEG, seed=0, symmetric=True)
    big["gen_symmetric_s"] = round(time.time() - t0, 1)
    oracle = {}
    for kernel in ("routed", "auto"):
        r, line, counts = _bfs_on_card(gs, kernel, oracle)
        routed = kernel == "routed"
        if routed and (r.plan.kernel != "routed_hier" or any(counts[k] <= 0 for k in FWD_HIER)):
            raise AssertionError(f"bfs 1M routed: {r.plan.kernel}, {counts}")
        if not routed:
            _note_auto("bfs 1M", r.plan)
        if not routed and (not r.plan.kernel.startswith("xla_") or any(counts.values())):
            raise AssertionError(f"bfs 1M auto: {r.plan.kernel}, {counts}")
        if routed:
            _add_launches(kernels, "launches_bfs_1m", [_hier_nonzero(counts)])
            big["passes_bfs"] = _graph_pass_checks(r.plan, None, "bfs 1M plan")
        big[f"bfs_{kernel}"] = line
        del r
        torch.cuda.empty_cache()
    summary = ("kernel", "build_s", "times_s", "time_s", "plan_bytes_on_card", "error",
               "x_l1_rel_diff")
    out["n1M"] = {k: ({kk: v[kk] for kk in summary if kk in v} if k.startswith(
        ("pagerank_", "bfs_")) else v) for k, v in big.items()}
    del gs, oracle

    # --- the un-permute network in f32 (n = 300 000, hierarchical)
    g = powerlaw_graph(GRAPH_UNPERM_N, GRAPH_DEG, seed=0)
    replica = _pagerank_replica(g, 25)
    runs = {}
    for relabel in (False, True):
        r, line, counts = _pagerank_on_card(g, "routed", replica, iters=25, runs=1,
                                            relabel=relabel)
        single = [PASS_FNS[k][1] for k in PASS_FNS]
        if r.plan.kernel != "routed_hier" or (r.plan.A.unperm is None) == (not relabel) \
                or (not relabel and any(counts[k] <= 0 for k in single)):
            raise AssertionError(f"pagerank 300k relabel={relabel}: {counts}")
        if not relabel:
            _add_launches(kernels, "launches_unperm_300k",
                          [{k: counts[k] for k in single}])
            unperm_passes = _unperm_pass_checks(r.plan, kernels)
        runs[relabel] = (r.x, line)
        del r
    diff = np.abs(runs[False][0] - runs[True][0])
    ok = bool((diff <= PR_RELABEL_TOL["atol"]
               + PR_RELABEL_TOL["rtol"] * np.abs(runs[True][0])).all())
    out["n300k_unperm"] = {"x_max_abs_diff": float(diff.max()), "within_tol": ok,
                           "launches_unrelabeled": runs[False][1]["launches"],
                           "passes": unperm_passes}
    emit({"phase": "graphs_unperm", **out["n300k_unperm"]})
    if not ok:
        raise AssertionError("pagerank 300k: relabeled and unrelabeled x differ")
    del runs, g
    torch.cuda.empty_cache()
    out["wall_s"] = round(time.time() - t_phase, 1)
    emit(out)
    return out


def phase_graph_profile() -> dict:
    """Opt-in: where a PageRank iteration at n = 1 000 000 spends its time.
    For the routed plan and the gather path, torch.profiler traces 1 and 10
    iterations (after a warm-up), beside the untraced wall of 10; each
    trace's device time is split between the port's kernels and PyTorch's."""
    from lilac_tpu_torch.generate.graphs import powerlaw_graph
    from lilac_tpu_torch.workloads import pagerank

    g = powerlaw_graph(GRAPH_N, GRAPH_DEG, seed=0)
    n = g[3][0]
    out = {"phase": "graph_profile", "n": n, "nnz": len(g[1])}
    for kernel in ("routed", "auto"):
        plan = pagerank.run(*g, iters=1, runs=1, kernel=kernel, device=DEVICE).plan
        x = plan.vec_in(np.full(n, 1.0 / n))

        def iterations(k):
            return pagerank._iterate(plan, plan.A, x, n, 0.85, k)

        iterations(10)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        iterations(10)
        torch.cuda.synchronize()
        row = {"kernel": plan.kernel, "ten_iterations_untraced_ms":
               (time.perf_counter() - t0) * 1e3}
        for what, k in (("one_iteration", 1), ("ten_iterations", 10)):
            wall, ks, busy = _trace(lambda: iterations(k))
            s = _summary(wall, ks, busy, top=12)
            port_us = sum(us for name, (_, us) in ks.items()
                          if any(p in name for p in PORT_KERNELS))
            s["port_kernels_ms"] = port_us / 1e3
            s["torch_kernels_ms"] = s["device_busy_ms"] - port_us / 1e3
            s["launches_an_iteration"] = s["launches"] / k
            row[what] = s
        out[kernel] = row
        del plan, x
        torch.cuda.empty_cache()
    emit(out)
    return out


# ---------------------------------------------------------------------------
# PATHSAMPLE: pfold and tfold sweeps through the f64 gather plan, NGT
# ---------------------------------------------------------------------------

# a stand-in at a database's scale: the LJ38 min.data / ts.data files are
# not in the reference's checkout (lilac_tpu/workloads/pathsample.py:26-28)
PS_NMIN, PS_NTS = 100_000, 400_000
PS_T, PS_SWEEPS = 0.05, 10_000  # the bench's settings
PS_TOL = dict(rtol=1e-12, atol=1e-13)  # tests/test_pathsample.py:58
# the f64 host replicas (scipy, 20 to 23 s each at 10 000 sweeps) check a
# second, untimed run of this many sweeps: a depth cut that keeps the whole
# run inside its time limit
PS_REPLICA_SWEEPS = 2_000
# NGT's graph transformation is host Python on dicts and quadratic in its
# fill-in: 2 000 minima on a spanning tree with 200 more transition states
# (11 s on a host core; 4 TS a minimum take 600 s)
NGT_NMIN, NGT_NTS = 2000, 2200


def _pfold_replica(ip, ix, dv, has_row, q0, sweeps: int) -> np.ndarray:
    """The sweep q <- where(has_row, D q, q) on the host in f64 (scipy)."""
    import scipy.sparse as sp

    n = len(has_row)
    D = sp.csr_matrix((dv, ix, ip), shape=(n, n))
    q = q0.copy()
    for _ in range(sweeps):
        q = np.where(has_row, D @ q, q)
    return q


def _tfold_replica(db, temperature: float, sweeps: int) -> np.ndarray:
    """tfold's Jacobi sweep t <- where(free, tau + D t, pinned) on the host
    in f64 (scipy), from tfold's own host inputs."""
    import scipy.sparse as sp

    from lilac_tpu_torch.workloads import pathsample as ps

    ip, ix, dv, has_row, sink = ps.branching_matrix(
        db, temperature=temperature, block_opposite=False)
    n = db.nmin
    kplus, kminus = ps.log_rates(db, temperature)
    lnconn, _ = ps.connectivity_census(db, 0)
    live = (db.plus != db.minus) & (lnconn[db.plus] > 0) & (lnconn[db.minus] > 0)
    lksum = np.zeros(n)
    np.add.at(lksum, db.plus[live], np.exp(kplus[live]))
    np.add.at(lksum, db.minus[live], np.exp(kminus[live]))
    with np.errstate(divide="ignore"):
        tau = np.where(lksum > 0, 1.0 / lksum, 0.0)
    tau = np.where(sink, 0.0, tau)
    D = sp.csr_matrix((dv, ix, ip), shape=(n, n))
    free = has_row & ~sink
    pinned = np.where(sink, 0.0, tau)
    t = tau.copy()
    for _ in range(sweeps):
        t = np.where(free, tau + D @ t, pinned)
    return t


def _close(got, want, what: str) -> float:
    """Largest |got - want| / (atol + rtol |want|); fails above 1."""
    ratio = float((np.abs(got - want) / (PS_TOL["atol"] + PS_TOL["rtol"] * np.abs(want))).max())
    if not np.isfinite(got).all() or not ratio <= 1.0:
        raise AssertionError(f"{what}: off its host replica ({ratio:.3g} x the tolerance)")
    return ratio


def phase_pathsample() -> dict:
    """PATHSAMPLE (workloads/pathsample.py) on the card: pfold and tfold at
    the bench's T = 0.05 and 10 000 sweeps on a landscape of 100 000 minima
    and 400 000 transition states (timed, finite), and a second run of
    PS_REPLICA_SWEEPS sweeps each held to an f64 host replica of its sweeps; pfold's launches a sweep (torch.profiler over 10 sweeps); NGT
    with its seeded pfold; pfold against the dense committor at a mixing
    temperature; and the bench CLI's pathsample row."""
    from lilac_tpu_torch.plan import SpmvPlan
    from lilac_tpu_torch.workloads import pathsample as ps

    t_phase = time.time()
    t0 = time.time()
    db = ps.synthetic_landscape(nmin=PS_NMIN, nts=PS_NTS, seed=0)
    land_s = time.time() - t0
    t0 = time.time()
    ip, ix, dv, has_row, sink = ps.branching_matrix(db, temperature=PS_T)
    out = {"phase": "pathsample", "nmin": PS_NMIN, "nts": PS_NTS, "nnz": len(ix),
           "landscape_s": round(land_s, 2), "branching_s": round(time.time() - t0, 2),
           "temperature": PS_T, "sweeps": PS_SWEEPS, "tol": PS_TOL}

    t0 = time.time()
    r = ps.pfold(db, temperature=PS_T, npfold=PS_SWEEPS, device=DEVICE)
    pfold_wall = time.time() - t0
    if not (np.isfinite(r.committor).all() and np.isfinite(r.residual)):
        raise AssertionError(f"pfold: not finite, residual {r.residual}")
    rc = ps.pfold(db, temperature=PS_T, npfold=PS_REPLICA_SWEEPS, device=DEVICE)
    q0 = np.where(sink, 1.0, 0.0)
    t0 = time.time()
    want = _pfold_replica(ip, ix, dv, has_row, q0, PS_REPLICA_SWEEPS)
    out["pfold"] = {"time_s": r.time_s, "wall_s": round(pfold_wall, 2),
                    "residual": r.residual, "replica_sweeps": PS_REPLICA_SWEEPS,
                    "replica_s": round(time.time() - t0, 1),
                    "max_abs_diff": float(np.abs(rc.committor - want).max()),
                    "tol_ratio": _close(rc.committor, want, "pfold")}
    del rc
    plan = SpmvPlan(ip, ix, dv, (PS_NMIN, PS_NMIN), dtype="f64", device=DEVICE)
    q, mask = plan.vec_in(q0), torch.as_tensor(has_row, device=DEVICE)

    def sweeps():
        p = q
        for _ in range(10):
            p = torch.where(mask, plan.matvec_with(plan.A, p), p)

    sweeps()
    _, ks, _ = _trace(sweeps)
    out["pfold"].update(kernel=plan.kernel, launches_a_sweep=sum(
        c for c, _ in ks.values()) / 10, kernels_a_sweep={
        name[:60]: c / 10 for name, (c, _) in ks.items()})
    del plan, q, mask, r

    r = ps.tfold(db, temperature=PS_T, ntfold=PS_SWEEPS, device=DEVICE)
    if not (np.isfinite(r.mfpt).all() and np.isfinite(r.kAB)):
        raise AssertionError(f"tfold: not finite, kAB {r.kAB}")
    rc = ps.tfold(db, temperature=PS_T, ntfold=PS_REPLICA_SWEEPS, device=DEVICE)
    t0 = time.time()
    want = _tfold_replica(db, PS_T, PS_REPLICA_SWEEPS)
    out["tfold"] = {"time_s": r.time_s, "kAB": r.kAB, "replica_sweeps": PS_REPLICA_SWEEPS,
                    "replica_s": round(time.time() - t0, 1),
                    "max_rel_diff": float((np.abs(rc.mfpt - want)
                                           / np.maximum(np.abs(want), 1e-300)).max()),
                    "tol_ratio": _close(rc.mfpt, want, "tfold")}
    del db, r, rc, want

    ndb = ps.synthetic_landscape(nmin=NGT_NMIN, nts=NGT_NTS, seed=0)
    t0 = time.time()
    r = ps.ngt(ndb, temperature=0.8, npfold=200, device=DEVICE)
    out["ngt"] = {"nmin": NGT_NMIN, "nts": NGT_NTS, "wall_s": round(time.time() - t0, 1),
                  "detailed_balance": r.detailed_balance, "kAB": r.kAB, "kBA": r.kBA}
    if not abs(r.detailed_balance - 1.0) <= 1e-10 or r.committor is None \
            or not (0.0 <= r.committor.min() and r.committor.max() <= 1.0 + 1e-9):
        raise AssertionError(f"ngt: {out['ngt']}")

    # the committor oracle's own landscape (tests/test_pathsample.py): at a
    # mixing temperature 4000 sweeps come within 1e-3 of the fixed point
    tdb = ps.synthetic_landscape(nmin=300, nts=1200, seed=3)
    dense = {}
    for direction in ("AB", "BA"):
        ref = ps.dense_committor(tdb, temperature=1.0, direction=direction)
        r = ps.pfold(tdb, temperature=1.0, direction=direction, npfold=4000, device=DEVICE)
        dense[direction] = float(np.abs(r.committor - ref).max())
    out["pfold_vs_dense"] = dense
    if not max(dense.values()) < 1e-3:
        raise AssertionError(f"pfold against the dense committor: {dense}")
    out["cli"] = _bench_cli("pathsample", "1000")
    out["wall_s"] = round(time.time() - t_phase, 1)
    emit(out)
    return out


# phase tools: the CLI's spgemm sizes and size 48 (n = 110 592, about 1.0 M
# entries in A; size 64, n = 262 144 with 21.8 M entries in C, took 39 s of
# host numpy and was cut to keep the whole run inside its time limit);
# spmv-roofline's sizes and 70 (n = 343 000 >
# 2^18: the routed plan is hierarchical); ingest at the CLI's n
TOOLS_SPGEMM_SIZES = (16, 24, 32, 48)
TOOLS_ROOFLINE_SIZES = (20, 40, 60, 70)
TOOLS_INGEST_N = 1_000_000
# the committed rows (lilac_tpu_torch/autotune/rows_h100.jsonl) cover the
# corpus; the phase's own collection only exercises collect_rows, so it is
# cut from 40 s to a few rows
TOOLS_AUTOTUNE_BUDGET_S = 5.0
TOOLS_AUTOTUNE_KERNELS = ("xla_ell", "xla_sell", "xla_csr", "routed")
TOOLS_SHARE_MAX = 1.05  # an HBM share or a stage floor over its matvec


def _tool_counts(rd, dfk) -> dict:
    """The launch counts of K1, K2 and the hierarchical wrappers, nonzero."""
    counts = {"routed_apply": rd.routed_apply.launches,
              "dfmulred": dfk.dfmulred.launches, **_hier_counts(rd)}
    return {k: v for k, v in counts.items() if v}


def _spgemm_bound(a, b, ref, got, what: str) -> float:
    """Every value of got (ESC or masked-dense, f32 sums) within
    (k + 2) 2^-24 sum_k |a_ik b_kj| of ref (expand_csr, f64), k the number
    of products summed into the entry: the products' and the inputs' f32
    roundings and an f32 sum of k terms in any order. The partial products
    are expanded once on the host and placed on C's entries by their
    (row, col) key. Returns the largest error over its bound."""
    (ap, ai, av), (bp, bi, bv) = a[:3], b[:3]
    n, m = a[3][0], b[3][1]
    ai, bi = ai.astype(np.int64), bi.astype(np.int64)
    lens = np.diff(bp)[ai]
    ends = np.cumsum(lens)
    pos = np.repeat(bp[ai].astype(np.int64), lens) + (
        np.arange(int(ends[-1]) if len(ends) else 0, dtype=np.int64)
        - np.repeat(ends - lens, lens))
    rows = np.repeat(np.repeat(np.arange(n, dtype=np.int64), np.diff(ap)), lens)
    ckey = np.repeat(np.arange(n, dtype=np.int64), np.diff(ref[0])) * m + ref[1]
    slot = np.searchsorted(ckey, rows * m + bi[pos])
    absum = np.bincount(slot, weights=np.abs(np.repeat(av, lens) * bv[pos]),
                        minlength=len(ckey))
    k = np.bincount(slot, minlength=len(ckey))
    err = np.abs(got[2] - ref[2])
    bound = (k + 2) * 2.0**-24 * absum
    if not (err <= bound).all():
        i = int(np.argmax(err - bound))
        raise AssertionError(f"spgemm {what}: entry {i} off by {err[i]:.3e}, "
                             f"bound {bound[i]:.3e} (k = {k[i]})")
    return float((err / np.where(bound > 0, bound, 1.0)).max())


def _esc_card_ms(sg, a, b) -> float:
    """Milliseconds of ESC's work on the card for the whole product as one
    group (expand, compact, sort, segment sum; its one read of the unique
    count included), the operands already there in ELL: what esc_spgemm
    spends outside host numpy."""
    from lilac_tpu_torch.formats.convert import csr_to_ell_arrays

    (va, ca), (vb, cb) = (csr_to_ell_arrays(x[0], x[1], x[2].astype(np.float32), x[3])
                          for x in (a, b))
    cnt_b = np.pad(np.diff(b[0]).astype(np.int32), (0, vb.shape[0] - b[3][0]))
    args = [torch.as_tensor(v, device=DEVICE) for v in (
        va[: a[3][0]], ca[: a[3][0]].astype(np.int64), np.diff(a[0]).astype(np.int32),
        vb, cb, cnt_b)]
    return time_ms(lambda: sg._esc_group(*args, b[3][1]), 3)


def _tools_spgemm(mean_nnz: float = 8.0) -> dict:
    """ESC on the card at each size: structure equal to expand_csr's, values
    within the f32 bound, two runs the same bits; masked_dense at the first
    size within the same bound; the CLI's lines at its own sizes."""
    from lilac_tpu_torch.bench import __main__ as bm
    from lilac_tpu_torch.generate.random_crs import random_crs
    from lilac_tpu_torch.ops import spgemm as sg

    cli = bm.spgemm([16, 24, 32], mean_nnz, DEVICE)
    if not all(r["struct_match"] for r in cli):
        raise AssertionError(f"bench spgemm: {cli}")
    out = {}
    for size in TOOLS_SPGEMM_SIZES:
        a = random_crs(size, seed=3, mean_nnz=mean_nnz, std_nnz=mean_nnz / 2)
        b = random_crs(size, seed=4, mean_nnz=mean_nnz, std_nnz=mean_nnz / 2)
        t0 = time.perf_counter()
        ref = sg.expand_csr(a[:3], b[:3], a[3], b[3])
        line = {"n": a[3][0], "nnz_a": len(a[1]), "nnz_c": len(ref[1]),
                "host_s": time.perf_counter() - t0}
        runs = []
        for _ in range(2):
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            runs.append(sg.esc_spgemm(a[:3], b[:3], a[3], b[3], device=DEVICE))
            line.setdefault("esc_s", []).append(time.perf_counter() - t0)
            line.setdefault("esc_peak_bytes", []).append(
                torch.cuda.max_memory_allocated() - base)
        got = runs[0]
        for i in (0, 1):
            if got[i].dtype != ref[i].dtype or not np.array_equal(got[i], ref[i]):
                raise AssertionError(f"spgemm {size}: ESC structure differs from expand_csr")
        if not np.array_equal(got[2].view(np.uint64), runs[1][2].view(np.uint64)):
            raise AssertionError(f"spgemm {size}: two ESC runs differ in their bits")
        line["esc_err_over_bound"] = _spgemm_bound(a, b, ref, got, f"esc {size}")
        line["esc_card_ms"] = _esc_card_ms(sg, a, b)
        line["group_rows"] = sg.esc_group_rows(
            a[3][0], int(np.diff(a[0]).max()), int(np.diff(b[0]).max()),
            sg.esc_budget_bytes(DEVICE))
        if size == TOOLS_SPGEMM_SIZES[0]:
            t0 = time.perf_counter()
            md = sg.masked_dense(a[:3], b[:3], a[3], b[3], device=DEVICE)
            line["masked_dense_s"] = time.perf_counter() - t0
            if not (np.array_equal(md[0], ref[0]) and np.array_equal(md[1], ref[1])):
                raise AssertionError(f"spgemm {size}: masked_dense structure differs")
            line["masked_dense_err_over_bound"] = _spgemm_bound(
                a, b, ref, md, f"masked_dense {size}")
        out[size] = line
        emit({"phase": "tools_spgemm", "size": size, **line})
    return out


def _tools_roofline(kernels: dict, rd, dfk) -> list:
    """spmv-roofline at its sizes and 70: at least one row beyond L2, every
    HBM share and every replayed stage floor within TOOLS_SHARE_MAX of its
    matvec; K1 on the single tables and the stage probes, K3-K5 on the
    size-70 hierarchical plan."""
    from lilac_tpu_torch.bench import __main__ as bm

    _reset_hier_counts(rd, dfk)
    rows = bm.spmv_roofline(TOOLS_ROOFLINE_SIZES, ["auto", "routed"], DEVICE)
    counts = _tool_counts(rd, dfk)
    _add_launches(kernels, "launches_tools_roofline", [counts])
    if all(r["l2_resident"] for r in rows):
        raise AssertionError("spmv-roofline: every row fits in L2")
    for r in rows:
        if (r["frac_hbm"] is not None and r["frac_hbm"] > TOOLS_SHARE_MAX) or (
                r["stage_share"] is not None and r["stage_share"] > TOOLS_SHARE_MAX):
            raise AssertionError(f"spmv-roofline: {r}")
    hier = [r for r in rows if r["kernel"] == "routed_hier"]
    if not hier or any(counts.get(k, 0) <= 0 for k in FWD_HIER + ("routed_apply",)):
        raise AssertionError(f"spmv-roofline: kernels {[r['kernel'] for r in rows]}, {counts}")
    return rows


def _tools_ingest(ddir: str) -> dict:
    """bench ingest at n = 1 000 000 (mtx) in a directory of its own: the
    arrays read back are the generated graph's bit for bit, and PageRank's x
    is, bit for bit, that of the same plan kernel on the graph in memory."""
    from lilac_tpu_torch.bench import __main__ as bm
    from lilac_tpu_torch.generate.graphs import powerlaw_graph
    from lilac_tpu_torch.plan import SpmvPlan
    from lilac_tpu_torch.workloads import pagerank

    res = _with_env({"LILAC_DATA_DIR": ddir}, lambda: bm.ingest(
        TOOLS_INGEST_N, 13.0, "mtx", "auto", 64, DEVICE))
    os.remove(res["path"])
    g = powerlaw_graph(TOOLS_INGEST_N, avg_deg=13.0, seed=7)
    for got, want in zip(res["arrays"][:3], g[:3]):
        if got.dtype != want.dtype or not np.array_equal(got, want):
            raise AssertionError("ingest: the arrays read differ from the graph written")
    if tuple(res["arrays"][3]) != tuple(g[3]):
        raise AssertionError("ingest: shape differs")
    scaled = pagerank.normalise_columns(*g[:3], g[3]) * 0.85
    plan = SpmvPlan(g[0], g[1], scaled, g[3], dtype="f32", kernel=res["kernel"],
                    reuse="many", device=DEVICE)
    r = pagerank.run(*g, iters=64, runs=1, plan=plan)
    if not np.array_equal(r.x.view(np.uint64), res["x"].view(np.uint64)):
        raise AssertionError(f"ingest: PageRank's x differs from the in-memory run's "
                             f"({res['kernel']})")
    return {k: res[k] for k in ("write_s", "read_s", "plan_s", "solve_s", "kernel",
                                "error")} | {"nnz": len(g[1]), "x_bit_identical": True}


def _family(name: str) -> str:
    return name.split("_")[0].rstrip("0123456789")


def _tools_autotune(kernels: dict, rd, dfk, ddir: str) -> dict:
    """collect_rows on corpus_v2(max_n=65536) for about 40 s into a file of
    its own: every row names the card and times routed; build_model_v2
    writes every meta field; with LILAC_AUTOTUNE_MODEL set to that model,
    an f32 SpmvPlan (reuse="once") takes predict's label where the model
    passes its ship gate, the heuristic's where it does not."""
    from lilac_tpu_torch import autotune
    from lilac_tpu_torch.generate.random_crs import random_crs
    from lilac_tpu_torch.plan import SpmvPlan

    rows_path = os.path.join(ddir, "rows_tools.jsonl")
    model_path = os.path.join(ddir, "model_tools.json")
    for p in (rows_path, model_path):
        if os.path.exists(p):
            os.remove(p)
    _reset_hier_counts(rd, dfk)
    t0 = time.time()
    n_new = autotune.collect_rows(rows_path, TOOLS_AUTOTUNE_KERNELS, max_n=65536,
                                  budget_s=TOOLS_AUTOTUNE_BUDGET_S, device=DEVICE)
    collect_s = time.time() - t0
    counts = _tool_counts(rd, dfk)
    _add_launches(kernels, "launches_tools_autotune", [counts])
    with open(rows_path) as f:
        rows = [json.loads(ln) for ln in f]
    card = torch.cuda.get_device_name(0)
    if n_new < 2 or len(rows) != n_new or counts.get("routed_apply", 0) <= 0 or any(
            r["device"] != card or "routed" not in r["times"] for r in rows):
        raise AssertionError(f"autotune rows: {n_new}, {counts}, {rows[:2]}")
    winners: dict = {}
    for r in rows:
        fam = winners.setdefault(_family(r["name"]), {})
        best = min(r["times"], key=r["times"].get)
        fam[best] = fam.get(best, 0) + 1
    autotune.build_model_v2(rows_path, model_path)
    with open(model_path) as f:
        meta = json.load(f)["meta"]
    want = {"corpus_rows", "holdout_frac", "holdout_splits", "train_accuracy",
            "test_accuracy", "majority_accuracy", "heuristic_accuracy", "gated_ok",
            "label_counts", "source", "device"}
    if not want <= set(meta) or meta["device"] != card or meta["corpus_rows"] != len(rows):
        raise AssertionError(f"autotune model meta: {meta}")
    ip, ix, dv, sh = random_crs(20, seed=5)
    cnt = np.diff(ip)

    def select():
        autotune._cached_model = autotune._cached_path = None
        try:
            plan = SpmvPlan(ip, ix, dv, sh, dtype="f32", reuse="once", device=DEVICE)
            return (plan.kernel, autotune.installed_model(DEVICE) is not None,
                    autotune.predict(sh[0], len(ix), float(cnt.mean()), float(cnt.std()),
                                     device=DEVICE))
        finally:
            autotune._cached_model = autotune._cached_path = None

    got, installed, label = _with_env({"LILAC_AUTOTUNE_MODEL": model_path}, select)
    spread = cnt.max() > 1.5 * max(cnt.mean(), 1.0) + 4
    heuristic = "xla_sell" if spread else "xla_ell"
    # predict is None beyond the collected rows' extent: the heuristic serves
    if installed != meta["gated_ok"] or got != (label or heuristic):
        raise AssertionError(f"autotune selection: {got}, installed {installed}, "
                             f"label {label}, gated_ok {meta['gated_ok']}")
    return {"rows": len(rows), "collect_s": round(collect_s, 1),
            "winners_by_family": winners, "selected": got, "gated_ok": meta["gated_ok"],
            **{k: meta[k] for k in ("test_accuracy", "majority_accuracy",
                                    "heuristic_accuracy", "label_counts")}}


def _tools_committed_model(ddir: str) -> dict:
    """The package's committed rows and model: every row names one card,
    build_model_v2 on the rows gives the committed weights (to 1e-12
    relative: another machine's numpy) and the same meta, installed_model
    serves it on this card exactly when its meta names this card and its
    ship gate holds; for each f32 `auto` path noted so far (each took this
    card's AUTO_EXPECTED kernel), the model's label (None beyond its
    corpus) and the heuristic's."""
    from lilac_tpu_torch import autotune

    if os.environ.get("LILAC_AUTOTUNE_MODEL"):
        raise AssertionError("LILAC_AUTOTUNE_MODEL is set: the committed model is not asked")
    card = torch.cuda.get_device_name(0)
    rows = autotune._read_rows(autotune.DEFAULT_ROWS_PATH)
    with open(autotune.DEFAULT_MODEL_PATH) as f:
        committed = json.load(f)
    meta = committed["meta"]
    again = os.path.join(ddir, "model_again.json")
    autotune.build_model_v2(autotune.DEFAULT_ROWS_PATH, again, verbose=False)
    with open(again) as f:
        rebuilt = json.load(f)
    os.remove(again)
    same_weights = all(np.allclose(rebuilt[k], committed[k], rtol=1e-12, atol=1e-12)
                       for k in ("mean", "scale", "W", "b"))
    autotune._cached_model = autotune._cached_path = None
    served = autotune.installed_model(DEVICE) is not None
    serves = bool(meta["gated_ok"]) and meta["device"] == card
    labels = []
    for p in AUTO_PATHS:
        st = p["row_stats"]
        spread = st["max_row"] > 1.5 * max(st["mean_row"], 1.0) + 4
        labels.append({"path": p["path"], "dtype": p["dtype"], "kernel": p["kernel"],
                       "model_label": autotune.predict(
                           st["nrows"], st["nnz"], st["mean_row"], st["std_row"],
                           device=DEVICE),
                       "heuristic": "xla_sell" if spread else "xla_ell"})
    out = {"rows": len(rows), "row_devices": sorted({r["device"] for r in rows}),
           "meta": meta, "rebuilt_same_weights": same_weights,
           "rebuilt_same_meta": rebuilt["meta"] == meta, "card": card,
           "served_here": served, "auto_paths": labels}
    if {r["device"] for r in rows} != {meta["device"]} or len(rows) != meta["corpus_rows"] \
            or not same_weights or rebuilt["meta"] != meta or served != serves \
            or rebuilt["classes"] != committed["classes"]:
        raise AssertionError(f"committed autotune model: {out}")
    return out


def _tools_checkpoint(kernels: dict, rd, dfk, ddir: str) -> dict:
    """checkpointed_power_method on class A in df64 through the factored
    plan (K1, K2): 8 outer steps, then a restart from the file to all 15;
    the zeta history and x bit for bit those of one uninterrupted run, and
    verified."""
    from lilac_tpu_torch.generate.npb import CLASSES
    from lilac_tpu_torch.plan import FactoredNPBPlan
    from lilac_tpu_torch.utils import checkpoint as ck

    cls = CLASSES["A"]
    plan = FactoredNPBPlan("A", dtype="df64", device=DEVICE)
    x0 = plan.vec_in(np.ones(cls.na))
    paths = [os.path.join(ddir, f"ckpt_{i}.npz") for i in (0, 1)]
    for p in paths:
        if os.path.exists(p):
            os.remove(p)
    _reset_hier_counts(rd, dfk)
    z8, _, s8 = ck.checkpointed_power_method(plan, x0, cls.shift, 8, path=paths[0], every=4)
    z, x, start = ck.checkpointed_power_method(plan, x0, cls.shift, cls.niter,
                                               path=paths[0], every=4)
    counts = _tool_counts(rd, dfk)
    _add_launches(kernels, "launches_tools_checkpoint", [counts])
    zu, xu, _ = ck.checkpointed_power_method(plan, x0, cls.shift, cls.niter,
                                             path=paths[1], every=cls.niter)
    for p in paths:
        os.remove(p)
    rel = abs(z[-1] - cls.zeta_verify) / cls.zeta_verify
    if (s8, start, len(z8), len(z)) != (0, 8, 8, cls.niter) \
            or not np.array_equal(z.view(np.uint64), zu.view(np.uint64)) \
            or not all(_bits_equal(a, b) for a, b in zip(x, xu)) or rel > 1e-10 \
            or any(counts.get(k, 0) <= 0 for k in ("routed_apply", "dfmulred")):
        raise AssertionError(f"checkpoint: start {start}, rel {rel:.3e}, {counts}, "
                             f"{z.tolist()} vs {zu.tolist()}")
    return {"kernel": plan.kernel, "steps": cls.niter, "resumed_at": start,
            "zeta": float(z[-1]), "zeta_rel_err": rel, "bit_identical": True}


def phase_tools(kernels: dict) -> dict:
    """The tooling on the card: spgemm (ESC against the host, bit for bit in
    structure, its values within the f32 bound), spmv-roofline, marshall,
    devices / config, ingest, the autotune corpus and model, the checkpoint
    restart, and bench_npb's fingerprint."""
    from lilac_tpu_torch import bench_npb
    from lilac_tpu_torch.bench import __main__ as bm
    from lilac_tpu_torch.config import cfg
    from lilac_tpu_torch.kernels import dfmulred as dfk
    from lilac_tpu_torch.kernels import routed as rd
    from lilac_tpu_torch.utils.profiling import CHIP_SPECS, chip_spec

    t_phase = time.time()
    ddir = os.path.join(cfg().resolved_data_dir(), "tools_smoke")
    os.makedirs(ddir, exist_ok=True)
    out: dict = {"phase": "tools"}
    walls = {}
    t0 = time.time()
    out["spgemm"] = _tools_spgemm()
    walls["spgemm"] = time.time() - t0
    t0 = time.time()
    out["spmv_roofline"] = _tools_roofline(kernels, rd, dfk)
    walls["spmv_roofline"] = time.time() - t0
    t0 = time.time()
    out["marshall"] = bm.marshall(30, DEVICE)
    bm.main(["devices"])
    bm.main(["config"])
    if chip_spec(DEVICE) != CHIP_SPECS["H100"] or "H100" not in torch.cuda.get_device_name(0) \
            or "LILAC_AUTOTUNE_MODEL" not in cfg().describe():
        raise AssertionError("devices / config: the card's spec or the knob is missing")
    walls["marshall_devices_config"] = time.time() - t0
    t0 = time.time()
    out["ingest"] = _tools_ingest(ddir)
    walls["ingest"] = time.time() - t0
    emit({"phase": "tools_ingest", **out["ingest"]})
    t0 = time.time()
    out["autotune"] = _tools_autotune(kernels, rd, dfk, ddir)
    walls["autotune"] = time.time() - t0
    emit({"phase": "tools_autotune", **out["autotune"]})
    t0 = time.time()
    out["committed_model"] = _tools_committed_model(ddir)
    walls["committed_model"] = time.time() - t0
    emit({"phase": "tools_committed_model", **out["committed_model"]})
    t0 = time.time()
    out["checkpoint"] = _tools_checkpoint(kernels, rd, dfk, ddir)
    walls["checkpoint"] = time.time() - t0
    _reset_hier_counts(rd, dfk)
    fp = bench_npb.fingerprint(quick=False)
    _add_launches(kernels, "launches_tools_fingerprint", [_tool_counts(rd, dfk)])
    if "error" in fp or not fp["hbm_copy_gbps"] > 0:
        raise AssertionError(f"bench_npb fingerprint: {fp}")
    out["fingerprint"] = fp
    out["walls_s"] = {k: round(v, 1) for k, v in walls.items()}
    out["wall_s"] = round(time.time() - t_phase, 1)
    emit({k: v for k, v in out.items() if k not in ("spgemm", "ingest", "autotune",
                                                    "committed_model")})
    return out


# phase dist: lilac_tpu_torch.parallel on the card. Four ranks share the one
# card through the host transport (Gloo); one rank a card takes NCCL.
DIST_RANKS = 4
DIST_NPB_CLASS = "B"  # the JAX package's distributed verification target
DIST_STENCIL = 64  # seven_point_csr(64, 64, 64): n = 262 144
DIST_RCRS = 64  # random_crs(64): weak-scaling's matrix at per_dev_n = 65 536 x 4
DIST_CG_MAXIT = 50
DIST_BICG_MAXIT = 100
# a matvec against the single-card gather plan, max |y - y_ref| / max |y_ref|:
# the JAX package's distributed test tolerances (tests/test_dist.py:52)
DIST_MATVEC_TOL = {"f32": 3e-5, "f64": 1e-12, "df64": 5e-13}
# 50 CG steps against the single-card cg_solve, the same measure: the sums
# are taken in other orders and CG carries their rounding from step to step
DIST_CG_TOL = {"f64": 1e-9, "df64": 1e-9}
DIST_ZETA_HIST_TOL = 1e-12  # class B's zeta history, 4 ranks against 1
DIST_KERNELS = ("routed_apply", "routed_apply_sliced", "butterfly_apply",
                "window_shift_apply", "bigshift_apply")


def _dist_counts(rd) -> dict:
    return {"routed_apply": rd.routed_apply.launches,
            **{w.__name__: w.launches for w in (rd.routed_apply_sliced, rd.butterfly_apply,
                                                rd.window_shift_apply, rd.bigshift_apply)}}


def _dist_reset(rd, mesh) -> None:
    for w in (rd.routed_apply, rd.routed_apply_sliced, rd.butterfly_apply,
              rd.window_shift_apply, rd.bigshift_apply):
        w.launches = 0
    torch.cuda.synchronize()
    mesh.reset_stats()


def _dist_rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300))


def _dist_matvec_ms(plan, x, reps: int = 5) -> dict:
    """Host-clock ms of one matvec (synchronised before and after) and of
    the collectives inside it: the transport's share."""
    mesh = plan.mesh
    plan.local_matvec(plan.a_arrays, x)
    torch.cuda.synchronize()
    mesh.reset_stats()
    t0 = time.perf_counter()
    for _ in range(reps):
        plan.local_matvec(plan.a_arrays, x)
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / reps * 1e3
    return {"matvec_ms": ms, "collective_ms": mesh.seconds / reps * 1e3,
            "collective_share": mesh.seconds / reps * 1e3 / ms,
            "collective_bytes": mesh.bytes // reps}


def _dist_npb_rank(mesh, csr, class_name: str) -> dict:
    """NPB (class_name) df64 through DistSpmvPlan: the timed power method
    (histories read once, synchronised), then one matvec's transport share."""
    from lilac_tpu_torch.ops import dfloat as df
    from lilac_tpu_torch.generate.npb import CLASSES
    from lilac_tpu_torch.parallel.dist import DistSpmvPlan, dist_npb_power_method

    cls = CLASSES[class_name]
    plan = DistSpmvPlan.build(*csr, (cls.na, cls.na), mesh, dtype="df64")
    x0 = plan.vec_in(np.ones(cls.na))
    torch.cuda.synchronize()
    mesh.reset_stats()
    t0 = time.perf_counter()
    zetas, rnorms, _ = dist_npb_power_method(plan, x0, cls.shift, cls.niter)
    zetas = (zetas.hi.cpu().numpy(), zetas.lo.cpu().numpy())
    time_s = time.perf_counter() - t0
    out = {"time_s": time_s, "build_s": plan.build_s, "collectives": mesh.calls,
           "collective_s": mesh.seconds, "zetas": zetas,
           "rnorm_last": float(df.to_f64(rnorms)[-1]), "transport": mesh.transport,
           "plan_bytes": plan.data.numel() * plan.data.element_size()
           + plan.indices.numel() * plan.indices.element_size(),
           **_dist_matvec_ms(plan, x0)}
    return out


def _dist_k1_check(rd, planes, masks, kinds, dists, what: str) -> None:
    got = rd.routed_apply(planes, masks, kinds, dists)
    torch.cuda.synchronize()
    want = rd.routed_apply_plain(planes, masks, kinds, dists)
    if not all(_bits_equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"{what}: routed_apply != routed_apply_plain "
                             f"{_bits_diff(got, want)}")


def _dist_solve_rank(mesh, npb, stencil, rcrs, xs, xr) -> dict:
    """Phase dist's plans on this rank: NPB (npb = (csr, class name)) through
    _dist_npb_rank, then the stencil and random_crs plans: every matvec and
    solve gathered whole, the launches of the path, then the first matvec's
    planes through each kernel against its plain version."""
    from lilac_tpu_torch.ops import dfloat as df
    from lilac_tpu_torch.kernels import routed as rd
    from lilac_tpu_torch.parallel.dist import (
        DistSpmvPlan,
        dist_bicg_solve,
        dist_cg_solve,
        dist_transposed_plan,
    )
    from lilac_tpu_torch.parallel.dist_routed import (
        DistRoutedHierPlan,
        DistRoutedPlan,
        HaloRoutedPlan,
        _route_planes,
    )
    from lilac_tpu_torch.parallel.halo import HaloSpmvPlan, ghost_concat

    out: dict = {"rank": mesh.rank, "transport": mesh.transport,
                 "npb": _dist_npb_rank(mesh, *npb)}
    torch.cuda.empty_cache()
    counts = dict.fromkeys(DIST_KERNELS, 0)

    def drive(name, plan, x, cg=None):
        """A matvec (and a CG of DIST_CG_MAXIT steps) with the kernels counted."""
        _dist_reset(rd, mesh)
        t0 = time.perf_counter()
        y = plan.vec_out(plan.local_matvec(plan.a_arrays, plan.vec_in(x)))
        row = {"y": y, "build_s": plan.build_s, "first_matvec_s": time.perf_counter() - t0}
        if cg:
            t0 = time.perf_counter()
            xc, it, _ = dist_cg_solve(plan, plan.vec_in(np.ones(plan.shape[0])),
                                      maxit=DIST_CG_MAXIT, rtol=1e-14)
            row.update(cg_x=plan.vec_out(xc), cg_it=it, cg_s=time.perf_counter() - t0)
        for k, v in _dist_counts(rd).items():
            counts[k] += v
        row["launches"] = _dist_counts(rd)
        row.update(_dist_matvec_ms(plan, plan.vec_in(x)))
        out[name] = row

    hp = HaloSpmvPlan.build(*stencil, mesh, dtype="f64")
    out["halo_dist_ks"], out["halo_halos"] = hp.dist_ks, hp.halos
    drive("halo_f64", hp, xs, cg=True)
    del hp
    hr = HaloRoutedPlan.build(*stencil, mesh, dtype="df64")
    drive("halo_routed_df64", hr, xs, cg=True)
    out["halo_routed_table"] = {"m": hr.m, "nets": len(hr.chunks), "stages": len(hr.kinds)}
    x = hr.vec_in(xs)
    x_ext = ghost_concat(mesh, hr.dist_ks, torch.stack([x.hi, x.lo]), hr.send_tbls)
    _dist_k1_check(rd, _route_planes((x_ext[0], x_ext[1]), hr.m), hr.masks, hr.kinds,
                   hr.dists, f"rank {mesh.rank}: HaloRoutedPlan df64")
    del hr, x, x_ext

    rp = DistRoutedPlan.build(*rcrs, mesh, dtype="f32")
    drive("routed_f32", rp, xr)
    out["routed_table"] = {"m": rp.m, "nets": len(rp.chunks), "stages": len(rp.kinds)}
    _dist_k1_check(rd, _route_planes(rp._gathered_planes(rp.vec_in(xr)), rp.m), rp.masks,
                   rp.kinds, rp.dists, f"rank {mesh.rank}: DistRoutedPlan f32")
    del rp
    hier = DistRoutedHierPlan.build(*rcrs, mesh, dtype="df64")
    drive("hier_df64", hier, xr)
    census: dict = {}
    for meta_b in hier.net_meta:
        for meta in meta_b:
            census[meta[0]] = census.get(meta[0], 0) + 1
    out["hier_plan"] = {"m": hier.m, "bl": hier.bl, "nets": len(hier.nets),
                        "pass_census": census}
    pads = tuple(_route_planes(hier._gathered_planes(hier.vec_in(xr)), hier.m))
    for b, passes in enumerate(hier.nets):
        _walk_schedule(rd, pads, [p[:-1] for p in passes], [p[-1] for p in passes],
                       hier.bl, False, f"rank {mesh.rank}: DistRoutedHierPlan df64 net {b}")
    del hier, pads

    plan = DistSpmvPlan.build(*rcrs, mesh, dtype="df64")
    plan_t = dist_transposed_plan(*rcrs, mesh, dtype="df64")
    t0 = time.perf_counter()
    xb, its, hist, rn = dist_bicg_solve(plan, plan_t, plan.vec_in(np.ones(rcrs[3][0])),
                                        maxit=DIST_BICG_MAXIT, rtol=1e-6)
    out["bicg"] = {"x": plan.vec_out(xb), "its": its, "hist": hist,
                   "rnorm": float(df.to_f64(rn)), "s": time.perf_counter() - t0}
    out["launches"] = counts
    return out


def _dist_single_card(stencil, rcrs, xs, xr) -> dict:
    """The single-card references of phase dist on the gather path: SpmvPlan
    (xla_ell in f32 / f64, xla_ell_df in df64), cg_solve and BiCG with the
    exact transpose staged as a second plan."""
    from lilac_tpu_torch.ops import dfloat as df
    from lilac_tpu_torch.plan import SpmvPlan, transposed_plan
    from lilac_tpu_torch.solvers.algebra import get_algebra
    from lilac_tpu_torch.solvers.bicg import bicg_solve
    from lilac_tpu_torch.solvers.cg import cg_solve

    def gather_plan(csr, dtype):
        return SpmvPlan(*csr, dtype=dtype, kernel="xla_ell_df" if dtype == "df64"
                        else "xla_ell", device=DEVICE)

    ref: dict = {}
    for name, csr, x, dtype, cg in (("halo_f64", stencil, xs, "f64", True),
                                    ("halo_routed_df64", stencil, xs, "df64", True),
                                    ("routed_f32", rcrs, xr, "f32", False),
                                    ("hier_df64", rcrs, xr, "df64", False)):
        p = gather_plan(csr, dtype)
        ref[name] = {"y": p.vec_out(p.matvec(p.vec_in(x)))}
        if cg:
            xc, it, _ = cg_solve(p.matvec_with, get_algebra(dtype, DEVICE), p.A,
                                 p.vec_in(np.ones(csr[3][0])), maxit=DIST_CG_MAXIT, rtol=1e-14)
            ref[name].update(cg_x=p.vec_out(xc), cg_it=it)
    p = gather_plan(rcrs, "df64")
    pt = transposed_plan(*rcrs, dtype="df64", kernel="xla_ell_df", device=DEVICE)
    alg = get_algebra("df64", DEVICE)
    b = p.vec_in(np.ones(rcrs[3][0]))
    xb, its, hist, rn, _ = bicg_solve(lambda A, v: p.matvec(v), lambda A, v: pt.matvec(v), alg,
                                      None, b, alg.zeros_like(b), maxit=DIST_BICG_MAXIT,
                                      rtol=1e-6)
    ref["bicg"] = {"x": p.vec_out(xb), "its": its, "hist": hist.cpu().numpy(),
                   "rnorm": float(df.to_f64(rn))}
    return ref


def phase_dist(kernels: dict) -> dict:
    """lilac_tpu_torch.parallel on the card, through run_spmd's ranks:

    * dryrun_multichip(1) under NCCL (transport "device") and (4) under Gloo
      (transport "host", four ranks sharing the card), every plan family
      one step, the two runs' vectors equal to f32 rounding;
    * NPB class B df64 through DistSpmvPlan, uncut: zeta verified to 1e-10
      on 4 ranks (host transport) and on 1 rank under NCCL, the two zeta
      histories equal to 1e-12, the times and one matvec's transport share
      side by side;
    * on 4 ranks, seven_point_csr(64, 64, 64) through HaloSpmvPlan (f64; its
      kept ring distances 1 and 3) and HaloRoutedPlan (df64, K1), and
      random_crs(64) through DistRoutedPlan (f32, K1) and DistRoutedHierPlan
      (df64 at the card's bl, K3u-K6u): each matvec held to the single-card
      gather plan, 50 CG steps on the stencil plans to the single-card
      cg_solve, BiCG (100 iterations) with dist_transposed_plan to the
      single-card BiCG with the exact transpose (its first SB_HIST_FIRST
      norms to SB_HIST_TOL); every rank's first matvec of each routed plan
      through K1 and every K3u-K6u pass bit for bit against the plain
      versions; each rank's launches gathered into the kernels line;
    * bench weak-scaling --devices 1,2,4 (its default sizes)."""
    from lilac_tpu_torch.bench import __main__ as bm
    from lilac_tpu_torch.generate.npb import CLASSES, make_cg_matrix
    from lilac_tpu_torch.generate.random_crs import random_crs
    from lilac_tpu_torch.generate.stencil import seven_point_csr
    from lilac_tpu_torch.parallel.dryrun import dryrun_multichip
    from lilac_tpu_torch.parallel.launch import run_spmd, same_bits

    t_phase = time.time()
    out: dict = {"phase": "dist"}
    walls = {}
    t0 = time.time()
    dry = {}
    for n, backend in ((1, "nccl"), (DIST_RANKS, "gloo")):
        res = dryrun_multichip(n, DEVICE, backend=backend)
        if not same_bits(res) or any(not np.isfinite(v).all() for k, v in res[0].items()
                                     if isinstance(v, np.ndarray)):
            raise AssertionError(f"dryrun_multichip({n}, {backend}): ranks differ or not finite")
        dry[n] = res[0]
    for k in ("cg", "halo", "routed", "halo_routed", "routed_hier", "bicg"):
        rel = _dist_rel(dry[DIST_RANKS][k], dry[1][k])
        if rel > 1e-4:
            raise AssertionError(f"dryrun {k}: 4 ranks against 1 differ by {rel:.3e}")
    out["dryrun"] = {n: {"transport": r["transport"], "size": r["size"]}
                     for n, r in dry.items()}
    if (dry[1]["transport"], dry[DIST_RANKS]["transport"]) != ("device", "host"):
        raise AssertionError(f"dryrun transports: {out['dryrun']}")
    walls["dryrun"] = time.time() - t0
    emit({"phase": "dist_dryrun", **out["dryrun"], "wall_s": round(walls["dryrun"], 1)})

    t0 = time.time()
    cls = CLASSES[DIST_NPB_CLASS]
    ip, ix, dv, _ = make_cg_matrix(DIST_NPB_CLASS)
    walls["npb_matrix"] = time.time() - t0
    t0 = time.time()
    stencil = seven_point_csr(DIST_STENCIL, DIST_STENCIL, DIST_STENCIL)
    rcrs = random_crs(DIST_RCRS, seed=11, mean_nnz=16.0, std_nnz=8.0)
    rng = np.random.default_rng(61)
    xs, xr = rng.standard_normal(stencil[3][0]), rng.standard_normal(rcrs[3][0])
    res = run_spmd(_dist_solve_rank, DIST_RANKS, ((ip, ix, dv), DIST_NPB_CLASS), stencil,
                   rcrs, xs, xr, backend="gloo", device=DEVICE)
    walls["ranks_4"] = time.time() - t0
    t0 = time.time()
    res_1 = run_spmd(_dist_npb_rank, 1, (ip, ix, dv), DIST_NPB_CLASS, backend="nccl",
                     device=DEVICE)
    walls["npb_rank_1"] = time.time() - t0
    del ip, ix, dv
    npb = {}
    for n, backend, rows in ((DIST_RANKS, "gloo", [r["npb"] for r in res]),
                             (1, "nccl", res_1)):
        if not same_bits([r["zetas"] for r in rows]):
            raise AssertionError(f"NPB on {n} ranks: the ranks' zeta histories differ")
        r = dict(rows[0])
        zetas = r.pop("zetas")
        hist = zetas[0].astype(np.float64) + zetas[1].astype(np.float64)
        rel = abs(hist[-1] - cls.zeta_verify) / cls.zeta_verify
        if not rel <= 1e-10:
            raise AssertionError(f"NPB on {n} ranks ({backend}): zeta rel err {rel:.3e}")
        npb[n] = {**r, "ranks": n, "zeta": float(hist[-1]), "zeta_rel_err": rel,
                  "time_s_max_rank": max(q["time_s"] for q in rows), "hist": hist}
        emit({"phase": "dist_npb", "class": DIST_NPB_CLASS, "dtype": "df64",
              "plan": "DistSpmvPlan",
              **{k: v for k, v in npb[n].items() if k != "hist"}})
    d = _dist_rel(npb[DIST_RANKS].pop("hist"), npb[1].pop("hist"))
    if d > DIST_ZETA_HIST_TOL:
        raise AssertionError(f"NPB zeta history, 4 ranks against 1: {d:.3e}")
    out["npb"] = {"class": DIST_NPB_CLASS, "zeta_hist_4_vs_1": d,
                  **{f"ranks_{n}": v for n, v in npb.items()}}
    t0 = time.time()
    ref = _dist_single_card(stencil, rcrs, xs, xr)
    walls["single_card"] = time.time() - t0
    r0 = res[0]
    for name in ("halo_f64", "halo_routed_df64", "routed_f32", "hier_df64", "bicg"):
        keys = ("x", "its", "hist", "rnorm") if name == "bicg" else ("y", "cg_x", "cg_it")
        if not same_bits([[r[name].get(k) for k in keys] for r in res]):
            raise AssertionError(f"dist {name}: the ranks' results differ")
    if r0["halo_dist_ks"] != (1, 3):
        raise AssertionError(f"stencil halo: kept ring distances {r0['halo_dist_ks']}")
    runs = {}
    for name in ("halo_f64", "halo_routed_df64", "routed_f32", "hier_df64"):
        dtype = name.rsplit("_", 1)[1]
        got, want = r0[name], ref[name]
        row = {"matvec_rel_err": _dist_rel(got["y"], want["y"])}
        if row["matvec_rel_err"] > DIST_MATVEC_TOL[dtype]:
            raise AssertionError(f"dist {name} matvec: {row['matvec_rel_err']:.3e}")
        if "cg_x" in got:
            row["cg_rel_err"] = _dist_rel(got["cg_x"], want["cg_x"])
            row["cg_it"] = (got["cg_it"], want["cg_it"])
            if row["cg_rel_err"] > DIST_CG_TOL[dtype] or got["cg_it"] != want["cg_it"]:
                raise AssertionError(f"dist {name} CG: {row}")
            row["cg_s"] = max(r[name]["cg_s"] for r in res)
        row.update({k: got[k] for k in ("build_s", "first_matvec_s", "matvec_ms",
                                        "collective_ms", "collective_share",
                                        "collective_bytes", "launches")})
        runs[name] = row
    gb, wb = r0["bicg"], ref["bicg"]
    bicg = {"its": (gb["its"], wb["its"]), "s": max(r["bicg"]["s"] for r in res),
            "hist_rel_first": _hist_rel(gb["hist"], wb["hist"], SB_HIST_FIRST),
            "rnorm": (gb["rnorm"], wb["rnorm"]), "hist_last": (float(gb["hist"][-1]),
                                                               float(wb["hist"][-1]))}
    if bicg["hist_rel_first"] > SB_HIST_TOL or gb["its"] != wb["its"] \
            or not np.isfinite(gb["x"]).all():
        raise AssertionError(f"dist BiCG against the single card: {bicg}")
    runs["bicg_df64"] = bicg
    launches = dict.fromkeys(DIST_KERNELS, 0)
    for r in res:
        for k, v in r["launches"].items():
            launches[k] += v
    _add_launches(kernels, "launches_dist", [launches])
    census = r0["hier_plan"]["pass_census"]
    need = ["routed_apply", "routed_apply_sliced", "butterfly_apply", "window_shift_apply"]
    if census.get("bigshift"):
        need.append("bigshift_apply")
    if any(launches[k] <= 0 for k in need):
        raise AssertionError(f"dist: a kernel of the path was not launched: {launches}")
    out.update(runs=runs, launches=launches, hier_plan=r0["hier_plan"],
               halo_routed_table=r0["halo_routed_table"], routed_table=r0["routed_table"],
               halo={"dist_ks": r0["halo_dist_ks"], "halos": r0["halo_halos"]})
    emit({"phase": "dist_plans", "ranks": DIST_RANKS, "transport": r0["transport"],
          "stencil_n": stencil[3][0], "rcrs_n": rcrs[3][0],
          "rcrs_nnz": len(rcrs[1]), **{k: out[k] for k in (
              "runs", "launches", "hier_plan", "halo_routed_table", "routed_table", "halo")},
          "kernels_bit_identical_to_plain": True})
    del ref, res
    torch.cuda.empty_cache()

    t0 = time.time()
    out["weak_scaling"] = bm.weak_scaling(65536, 16.0, [1, 2, DIST_RANKS], 30, "f32", DEVICE)
    walls["weak_scaling"] = time.time() - t0
    tails = [r["tail"] for r in out["weak_scaling"]]
    if "ranks share one card" not in tails[-1] or out["weak_scaling"][-1]["transport"] != "host":
        raise AssertionError(f"weak-scaling: {out['weak_scaling']}")
    out["walls_s"] = {k: round(v, 1) for k, v in walls.items()}
    out["wall_s"] = round(time.time() - t_phase, 1)
    emit({k: v for k, v in out.items() if k not in ("runs", "hier_plan", "halo_routed_table",
                                                    "routed_table", "halo")})
    return out


PARTS = {"hier", "inner", "inner_diag", "window", "window_diag", "window_bt_diag", "k11",
         "tiles", "c", "d", "gemm", "gemm_diag", "parboil", "exchange_diag", "cg", "scan",
         "mixed", "seg", "sparsebench", "sb_profile", "graphs", "graph_profile",
         "pathsample", "tools", "dist", "dfdot", "dfops", "dfops_runs"}


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: this script runs on the GPU only",
              file=sys.stderr)
        return 1
    t_start = time.time()
    only = set(argv[1:])  # phases to run alone, for finding a fault
    if only - PARTS:
        raise SystemExit(f"unknown phase {sorted(only - PARTS)}: " + " | ".join(sorted(PARTS)))
    phase_device()
    phase_build()
    _set_peaks()
    kernels: dict = {}
    if "dfdot" in only:
        kernels["dfdot"] = phase_dfdot()
    if "dfops" in only:
        kernels["dfops"] = phase_dfops()
    if "dfops_runs" in only:
        phase_dfops_runs(kernels)
    if "mixed" in only:
        from lilac_tpu_torch.kernels import routed_spmv as rs
        from lilac_tpu_torch.workloads import npb_cg

        emit({"phase": "npb_mixed_small", "runs": _mixed_small()})
        plan_d = build_plan_d()
        res_d = npb_cg.run("D", dtype="df64", niter=MIXED_D_STEPS, plan=plan_d)
        d_bytes = rs.plan_bytes(plan_d.A.V)
        del plan_d
        torch.cuda.empty_cache()
        phase_mixed_d(kernels, res_d, d_bytes)
    if "seg" in only:
        phase_seg_general(kernels)
    if "k11" in only:
        phase_k11_small()
    if "tiles" in only:
        phase_tiles()
    if "inner" in only:
        phase_inner()
    if "inner_diag" in only:
        phase_inner_diag()
    if "window" in only:
        phase_window()
    if "window_diag" in only:
        phase_window_diag()
    if "window_bt_diag" in only:
        phase_window_bt_diag()
    if "exchange_diag" in only:
        phase_exchange_diag()
    if "cg" in only:
        phase_cg_solve()
    if "sparsebench" in only:
        phase_sparsebench(kernels)
    if "sb_profile" in only:
        phase_sb_profile()
    if "graphs" in only:
        phase_graphs(kernels)
    if "graph_profile" in only:
        phase_graph_profile()
    if "pathsample" in only:
        phase_pathsample()
    if "tools" in only:
        phase_tools(kernels)
    if "dist" in only:
        phase_dist(kernels)
    if "scan" in only:
        from lilac_tpu_torch.kernels import routed_spmv as rs
        from lilac_tpu_torch.workloads import npb_cg

        t0 = time.time()
        plan_d = build_plan_d()
        d_build_s = time.time() - t0
        res_d = npb_cg.run("D", dtype="df64", niter=3, plan=plan_d)
        d_bytes = rs.plan_bytes(plan_d.A.V)
        del plan_d
        torch.cuda.empty_cache()
        phase_npb_scan(res_d, d_bytes, d_build_s)
    if "c" in only:
        kernels.update(phase_kernels(build_plan_c()))
        phase_main_path_c(kernels)
    if "hier" in only:
        phase_hier_small()
        phase_hier_general(kernels)
    if "gemm_diag" in only:
        phase_gemm_diag()
    if "gemm" in only:
        phase_gemm(kernels)
    if "parboil" in only:
        phase_parboil(kernels)
    if "d" in only:
        plan_d = build_plan_d()
        phase_hier_class_d(plan_d, kernels)
        kernels.setdefault("dfmulred", {"name": "dfmulred", "launches": 0})
        _, res_d = phase_main_path_d(kernels, plan_d)
        del plan_d
        torch.cuda.empty_cache()
        phase_plan_mode_d(kernels, res_d)
    if only:
        emit({"phase": "total", "seconds": round(time.time() - t_start, 1)})
        emit({"kernels": [k for k in kernels.values() if len(k) > 1]})
        return 2  # a partial run proves nothing: never the contract's last line

    phase_eft()
    dfdot_row = phase_dfdot()
    dfops_row = phase_dfops()

    plan_c = build_plan_c()
    phase_k11_small()
    phase_tiles()
    kernels = phase_kernels(plan_c)
    kernels["dfdot"] = dfdot_row
    kernels["dfops"] = dfops_row
    del plan_c
    torch.cuda.empty_cache()

    phase_hier_small()
    phase_inner()
    phase_window()
    phase_hier_general(kernels)
    phase_seg_general(kernels)
    phase_npb_small()
    phase_gemm(kernels)
    phase_parboil(kernels)

    # the main paths at full width: class C (single table; auto = plan, then a
    # few steps of adj), class D (one hier plan; auto = adj, then a few steps
    # of plan)
    phase_main_path_c(kernels)
    phase_cg_solve()
    t0 = time.time()
    plan_d = build_plan_d()
    d_build_s = time.time() - t0
    phase_hier_class_d(plan_d, kernels)
    line_d, res_d = phase_main_path_d(kernels, plan_d)
    phase_dfops_runs(kernels, plan_d)
    del plan_d
    torch.cuda.empty_cache()
    line_mixed, res_mixed = phase_mixed_d(kernels, res_d, line_d["plan_bytes_on_card"])
    # class D's plan mode (a second 56-59 s plan build, 3 steps) runs in the
    # partial run "d" only: cut to keep the whole run inside its time limit
    line_scan = phase_npb_scan(res_d, line_d["plan_bytes_on_card"], d_build_s)
    _hold_to_gather(res_mixed, line_scan["class_d_zeta_history"],
                    "class D mixed against the scan layout (gather)")
    emit({"phase": "class_d_layouts",
          "bytes_on_card": {**line_mixed["bytes_on_card"],
                            "scan": line_scan["class_d"]["bytes_on_card"]["scan"]},
          "untraced_step_wall_s": {
              **line_mixed["untraced_step_wall_s"],
              "scan": line_scan["class_d"]["untraced_step_wall_s"]["scan"]}})
    phase_sparsebench(kernels)
    phase_graphs(kernels)
    phase_pathsample()
    phase_tools(kernels)
    phase_dist(kernels)

    names = ["routed_apply", "dfmulred", "dfdot", "dfops"] + [
        PASS_FNS[k][i] for i in (0, 1) for k in PASS_FNS] + ADJ_NAMES + [
        "routed_apply_t", "matmul_nt"]
    for name in names:
        k = kernels[name]
        if k["launches"] <= 0:
            raise AssertionError(f"kernel {name} was not launched on a driven path")
    emit({"phase": "total", "seconds": round(time.time() - t_start, 1)})
    emit({"kernels": [kernels[name] for name in names]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
