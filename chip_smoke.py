#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          (from the repository root, no arguments)

Drives lilac_tpu_torch's main path, NPB CG in df64 through the routed
factored operator, at the full width of NPB class C (na = 150000, the
widest class the single-table path serves), and proves on the card that

* the CUDA kernels build from csrc/ (nvcc, sm_90a),
* TwoSum / TwoProd inside the df64 kernel's translation unit are exact,
* each kernel agrees with its plain PyTorch version (and routed_apply with
  the numpy applier of the routing networks) at the shapes the main path
  gives it and at a small size,
* NPB class S verifies in f32 / f64 / df64 through both operators, and
  class C verifies (zeta rel. err <= 1e-10) in df64 through the routed
  one, with both kernels launched on that run.

It prints one JSON line per phase, then the line {"kernels": [...]} with
each kernel's measured time beside its bound, and last
{"ok": true, "device": {...}}. Any failure raises: the exit code is then
non-zero and no result line is printed. There is no CPU fall-back: with no
GPU the script fails at once.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# published peaks of one H100 SXM (NVIDIA data sheet): the bounds below are
# stated against them, with the card's power limit printed beside
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12

DEVICE = "cuda"  # every tensor of this script lives on the card


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
        name: [ln.strip() for ln in text.splitlines() if "registers" in ln]
        for name, text in info["ptxas"].items()
    }
    line = {"phase": "build", "seconds": round(info["seconds"], 2),
            "built": info["built"], "ptxas": regs}
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


def _k2_bound(K: int, R: int):
    nbytes = 4 * K * R * 4 + 2 * R * 4
    # per term: TwoProd 17, cross terms 4, TwoSum 6, compensation 2
    flops = 29 * K * R + 6 * R
    tb, tf = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return max(tb, tf), ("bytes" if tb >= tf else "operations"), nbytes


def phase_kernels(plan_c) -> dict:
    """Each kernel against its plain version, at m = 1024, at synthetic
    class-C-sized networks with all three stage kinds, and on the class C
    plan itself (the shapes the main path gives it), where it is timed."""
    from lilac_tpu_torch.kernels import dfmulred as dfk
    from lilac_tpu_torch.kernels import routed as rd
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
    k1_ms = time_ms(lambda: rd.routed_apply([xh, xl], V.masks, V.kinds, V.dists), 20)
    k1_plain_ms = time_ms(
        lambda: rd.routed_apply_plain([xh, xl], V.masks, V.kinds, V.dists), 3)
    # the composed gather out[b, k] = x[idx[b, k]] as one indexing call: not
    # the same inputs (it needs idx, which the network encodes), so it is a
    # yardstick beside the kernel, not its library counterpart
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
        "library_ms": None,
        "shape": {"m": m, "B": B, "stages": S, "planes": 2, "dtype": "float32"},
        "bytes": k1_bytes, "grids_per_call": S, "index_gather_ms": gather_ms,
    }

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
    k2_ms = time_ms(lambda: dfk.dfmulred(*k2_args), 200)
    k2_plain_ms = time_ms(lambda: dfk.dfmulred_plain(*k2_args), 5)
    bound_ms, bound_by, k2_bytes = _k2_bound(K_c, R_c)
    k2 = {
        "name": "dfmulred", "route": "cuda",
        "source": "lilac_tpu_torch/csrc/dfmulred.cu",
        "replaces": "lilac_tpu/kernels/dfmulred.py:94",
        "launches": 0, "max_abs_err": k2_err,
        "ms": k2_ms, "plain_ms": k2_plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "shape": {"K": K_c, "R": R_c, "dtype": "float32 (hi, lo)"},
        "bytes": k2_bytes,
    }
    emit({"phase": "kernels", "checked": checked,
          "times_ms": {"routed_apply": k1_ms, "routed_apply_plain": k1_plain_ms,
                       "dfmulred": k2_ms, "dfmulred_plain": k2_plain_ms}})
    return {"routed_apply": k1, "dfmulred": k2}


def _npb_line(res, **extra) -> dict:
    return {"class": res.class_name, "dtype": res.dtype, "kernel": res.kernel,
            "verified": bool(res.verified), "zeta": res.zeta,
            "zeta_rel_err": res.rel_err, "rnorm_last": res.rnorm_last,
            "time_s": res.time_s, "mops": res.mops, "niter": res.niter, **extra}


def phase_npb_small() -> list:
    """Class S through both operators in all three value policies."""
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
    emit({"phase": "npb_small", "runs": lines})
    return lines


def phase_main_path(kernels: dict, class_name: str) -> dict:
    """The main path: npb_cg.run in df64 through the routed operator, with
    every launch count set to 0 just before and read just after."""
    from lilac_tpu_torch.generate.npb import CLASSES
    from lilac_tpu_torch.kernels import dfmulred as dfk
    from lilac_tpu_torch.kernels import routed as rd
    from lilac_tpu_torch.workloads import npb_cg

    rd.routed_apply.launches = 0
    rd.routed_apply.stage_launches = 0
    dfk.dfmulred.launches = 0
    t0 = time.time()
    res = npb_cg.run(class_name, dtype="df64", kernel="factored", device=DEVICE)
    wall = time.time() - t0
    kernels["routed_apply"]["launches"] = rd.routed_apply.launches
    kernels["routed_apply"]["grid_launches"] = rd.routed_apply.stage_launches
    kernels["dfmulred"]["launches"] = dfk.dfmulred.launches
    matvecs = (res.niter + 1) * 26  # the untimed warm-up step included
    line = _npb_line(
        res, phase="npb", wall_s=wall, matvecs=matvecs,
        routed_apply_launches=rd.routed_apply.launches,
        routed_apply_grid_launches=rd.routed_apply.stage_launches,
        dfmulred_launches=dfk.dfmulred.launches,
        full_width=f"class {class_name}",
    )
    emit(line)
    if res.kernel != "factored_routed_df":
        raise AssertionError(f"main path ran {res.kernel}, not the routed operator")
    if not (res.verified and np.isfinite([res.zeta, res.rnorm_last]).all()):
        raise AssertionError(f"class {class_name} df64 failed verification: {line}")
    if res.niter != CLASSES[class_name].niter:
        raise AssertionError("main path did not run the full iteration count")
    if rd.routed_apply.launches != 2 * matvecs:
        raise AssertionError(
            f"routed_apply launched {rd.routed_apply.launches} times on "
            f"{matvecs} matvecs (two per matvec expected)")
    if dfk.dfmulred.launches < 2 * matvecs:
        raise AssertionError(f"dfmulred launched only {dfk.dfmulred.launches} times")
    return line


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: this script runs on the GPU only",
              file=sys.stderr)
        return 1
    t_start = time.time()
    from lilac_tpu_torch.plan import FactoredNPBPlan

    phase_device()
    phase_build()
    phase_eft()

    t0 = time.time()
    plan_c = FactoredNPBPlan("C", dtype="df64", device=DEVICE)
    if plan_c.kernel != "factored_routed_df":
        raise AssertionError(f"class C plan is {plan_c.kernel}")
    emit({"phase": "plan", "class": "C", "build_s": round(time.time() - t0, 2),
          "m": plan_c.A.V.m, "nets": [len(plan_c.A.V.chunks), len(plan_c.A.VT.chunks)],
          "stages": [len(plan_c.A.V.kinds), len(plan_c.A.VT.kinds)],
          "mask_planes": list(plan_c.A.V.masks.shape)})
    kernels = phase_kernels(plan_c)
    del plan_c
    torch.cuda.empty_cache()

    phase_npb_small()

    # the main path at full width
    phase_main_path(kernels, "C")

    for k in kernels.values():
        if k["launches"] <= 0:
            raise AssertionError(f"kernel {k['name']} was not launched on the main path")
    emit({"phase": "total", "seconds": round(time.time() - t_start, 1)})
    emit({"kernels": list(kernels.values())})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
