"""CLI: python -m lilac_tpu_torch.bench <subcommand>; see bench/__init__.py.

The reference's subcommands (lilac_tpu/bench/__main__.py), each on the
card; those added with the tooling that touch a device take --device
(default cuda):

* run / analyze      the suite's CSV rows and their geometric-mean speedups;
* graph-scale        PageRank or BFS on a synthetic scale-free graph;
* devices / config   the CUDA devices with their published peaks; the knobs;
* marshall           plan-build walls of the gather layouts and the routed
                     plans (f32, df64);
* spmv-roofline      a chain of 50 matvecs a plan: ms, Mnnz/s, GB/s against
                     the HBM peak (or `l2_resident` where the traffic fits the
                     card's L2), and the replayed stage floor's share;
* spgemm             C = A·B on the host, by ESC on the card, and densified;
* ingest             a graph file at scale: read -> plan -> PageRank;
* autotune-collect / autotune-train  the selector's corpus rows on the card
                     (resumable) and its training with the ship gate;
* weak-scaling       chained DistSpmvPlan matvecs on 1, 2, 4, ... ranks of a
                     problem that grows with the rank count: Mnnz/s a rank."""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from lilac_tpu_torch import bench
from lilac_tpu_torch.utils.profiling import synchronize

SPGEMM_DENSE_MAX = 64_000_000  # n·n up to which the densified product runs


def build_parser() -> argparse.ArgumentParser:
    from lilac_tpu_torch import autotune

    p = argparse.ArgumentParser(prog="lilac_tpu_torch.bench")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("run")
    pr.add_argument("--bench", required=True, choices=sorted(bench.BENCHES))
    pr.add_argument("--size", required=True)
    pr.add_argument("--impl", default="auto")
    pr.add_argument("--platform", default="gpu")
    pr.add_argument("--runs", type=int, default=5)
    pr.add_argument("--out", default="all.csv")

    pa = sub.add_parser("analyze")
    pa.add_argument("csv")
    pa.add_argument("--baseline", default="xla_ell")

    def with_device(name: str) -> argparse.ArgumentParser:
        q = sub.add_parser(name)
        q.add_argument("--device", default="cuda")
        return q

    with_device("devices")  # libspmv/cl-probe.cpp's role
    sub.add_parser("config")  # the knob catalogue

    pm = with_device("marshall")  # the *-slow marshalling probes' role
    pm.add_argument("--size", type=int, default=30)

    pf = with_device("spmv-roofline")
    pf.add_argument("--sizes", default="20,40,60")
    pf.add_argument("--kernels", default="auto,routed")

    pg = sub.add_parser("graph-scale")  # synthetic scale-free PageRank / BFS
    pg.add_argument("--n", type=int, default=1_000_000)
    pg.add_argument("--avg-deg", type=float, default=16.0)
    pg.add_argument("--iters", type=int, default=128)
    pg.add_argument("--kernels", default="auto,routed")
    pg.add_argument("--workload", default="pagerank", choices=["pagerank", "bfs"])

    ps = with_device("spgemm")  # C = A*B: host / esc / masked-dense
    ps.add_argument("--sizes", default="16,24,32")
    ps.add_argument("--mean-nnz", type=float, default=8.0)

    pw = with_device("weak-scaling")  # per-device nnz/s against device count
    pw.add_argument("--per-dev-n", type=int, default=65536)
    pw.add_argument("--mean-nnz", type=float, default=16.0)
    pw.add_argument("--devices", default="1,2,4,8")
    pw.add_argument("--reps", type=int, default=30)
    pw.add_argument("--dtype", default="f32")

    pi = with_device("ingest")  # file ingestion at scale: read -> plan -> solve
    pi.add_argument("--n", type=int, default=1_000_000)
    pi.add_argument("--avg-deg", type=float, default=13.0)
    pi.add_argument("--format", default="mtx", choices=["mtx", "crs"])
    pi.add_argument("--kernel", default="auto")
    pi.add_argument("--iters", type=int, default=64)

    # rows and model default to the package's own files, whatever the
    # working directory
    pc = with_device("autotune-collect")  # results/cgo/run_all's role
    pc.add_argument("--rows", default=autotune.DEFAULT_ROWS_PATH)
    pc.add_argument("--kernels", default="xla_ell,xla_sell,xla_csr,routed")
    pc.add_argument("--max-n", type=int, default=250_000)
    pc.add_argument("--budget-s", type=float, default=None)
    pc.add_argument("--reps", type=int, default=20)

    pt = sub.add_parser("autotune-train")  # results/cgo/suite.py's role (host)
    pt.add_argument("--rows", default=autotune.DEFAULT_ROWS_PATH)
    pt.add_argument("--out", default=None)
    pt.add_argument("--holdout", type=float, default=0.25)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.cmd == "run":
        row = bench.run_bench(
            args.bench, args.size, args.impl, platform=args.platform, runs=args.runs
        )
        bench.append_rows(args.out, [row])
        print(",".join(row.csv()))
    elif args.cmd == "analyze":
        recs = bench.tidy(args.csv)
        for (plat, b, impl), s in sorted(
            bench.geomean_speedups(recs, args.baseline).items()
        ):
            print(f"{plat:10s} {b:14s} {impl:16s} geomean speedup {s:8.3f}x")
    elif args.cmd == "graph-scale":
        graph_scale(args)
    elif args.cmd == "devices":
        devices(args.device)
    elif args.cmd == "config":
        from lilac_tpu_torch.config import cfg

        print(cfg().describe())
    elif args.cmd == "marshall":
        marshall(args.size, args.device)
    elif args.cmd == "spmv-roofline":
        spmv_roofline([int(s) for s in args.sizes.split(",")],
                      args.kernels.split(","), args.device)
    elif args.cmd == "spgemm":
        spgemm([int(s) for s in args.sizes.split(",")], args.mean_nnz, args.device)
    elif args.cmd == "weak-scaling":
        weak_scaling(args.per_dev_n, args.mean_nnz,
                     [int(d) for d in args.devices.split(",")], args.reps, args.dtype,
                     args.device)
    elif args.cmd == "ingest":
        ingest(args.n, args.avg_deg, args.format, args.kernel, args.iters, args.device)
    elif args.cmd == "autotune-collect":
        from lilac_tpu_torch import autotune

        n = autotune.collect_rows(
            args.rows, tuple(args.kernels.split(",")), max_n=args.max_n,
            budget_s=args.budget_s, reps=args.reps, device=args.device,
        )
        print(f"collected {n} new rows -> {args.rows}")
    elif args.cmd == "autotune-train":
        from lilac_tpu_torch import autotune

        autotune.build_model_v2(args.rows, args.out or autotune.DEFAULT_MODEL_PATH,
                                holdout=args.holdout)
    return 0


def graph_scale(args) -> None:
    from lilac_tpu_torch.generate.graphs import powerlaw_graph
    from lilac_tpu_torch.workloads import bfs, pagerank

    sym = args.workload == "bfs"
    print(f"generating power-law graph n={args.n} avg_deg={args.avg_deg}"
          f" symmetric={sym}")
    g = powerlaw_graph(args.n, avg_deg=args.avg_deg, seed=0, symmetric=sym)
    nnz = len(g[1])
    for kernel in args.kernels.split(","):
        if sym:
            r = bfs.run_benchmark(*g, runs=16, kernel=kernel)
            print(f"  bfs      n={args.n} nnz={nnz} kernel={kernel:12s}"
                  f" {r.time_s:7.3f} s / 16 sources")
        else:
            r = pagerank.run(*g, iters=args.iters, runs=2, kernel=kernel)
            t = min(r.times_s)
            print(f"  pagerank n={args.n} nnz={nnz} kernel={kernel:12s}"
                  f" {t:7.3f} s/run  {args.iters * nnz / t / 1e9:6.2f} Gnnz/s"
                  f"  err={r.error:.3e}")


def weak_scaling(per_dev_n: int, mean_nnz: float, counts, reps: int, dtype: str,
                 device="cuda") -> list:
    """The BASELINE weak-scaling protocol (>= 70% at >= 2 hosts): the
    problem grows with the rank count (random_crs of side (per_dev_n *
    ranks)^(1/3), fixed rows a rank), `reps` chained DistSpmvPlan matvecs,
    Mnnz/s a rank against the first count's. Each count runs on a group of
    its own: NCCL (transport "device") where every rank has a card of its
    own, Gloo (transport "host") where ranks share one card or run on the
    CPU; every line names it. An efficiency is printed only where it
    means something: each rank on a card of its own and at least 1 000 000
    entries a rank."""
    from lilac_tpu_torch.generate.random_crs import random_crs
    from lilac_tpu_torch.parallel.launch import run_spmd

    on_card = torch.device(device).type == "cuda"
    cards = torch.cuda.device_count() if on_card else 0
    base_rate = None
    rows = []
    for nd in counts:
        own_cards = on_card and nd <= cards
        side = max(2, round((per_dev_n * nd) ** (1.0 / 3.0)))
        indptr, indices, data, shape = random_crs(
            side, seed=11, mean_nnz=mean_nnz, std_nnz=mean_nnz / 2.0)
        res = run_spmd(bench.weak_scaling_rank, nd, indptr, indices, data, shape, dtype,
                       reps, backend="nccl" if own_cards else "gloo", device=device)
        t = max(r["s"] for r in res)  # the slowest rank's matvec
        nnz = len(indices)
        rate_dev = nnz / t / nd
        if base_rate is None:
            base_rate = rate_dev
        if own_cards and nnz // nd >= 1_000_000:
            tail = f"({rate_dev / base_rate:6.1%} weak-scaling efficiency)"
        elif on_card and not own_cards:
            tail = "(ranks share one card: rates are not weak scaling)"
        else:
            tail = "(path validated; rates not meaningful on this mesh)"
        transport = res[0]["transport"]
        print(f"  n_dev={nd} n={shape[0]:>9d} nnz={nnz:>10d} {t * 1e3:8.3f} ms  "
              f"{rate_dev / 1e6:8.1f} Mnnz/s/dev transport={transport} {tail}", flush=True)
        rows.append({"n_dev": nd, "n": shape[0], "nnz": nnz, "ms": t * 1e3,
                     "mnnz_s_dev": rate_dev / 1e6, "transport": transport,
                     "collective_ms": max(r["collective_s"] for r in res) * 1e3,
                     "tail": tail})
    return rows


def devices(device="cuda") -> list:
    """The devices of `device`'s type with the peaks chip_spec gives."""
    from lilac_tpu_torch.utils.profiling import chip_spec

    dev = torch.device(device)
    if dev.type == "cuda":
        names = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
    else:
        names = ["cpu"]
    for i, name in enumerate(names):
        print(f"device {i}: {name} platform={dev.type}")
    spec = chip_spec(dev)
    print("chip spec:", spec)
    return names


def marshall(size: int = 30, device="cuda") -> dict:
    """Plan-build walls on random_crs(size): the gather layouts through
    SpmvPlan, then the routed plans (build_routed_csr, f32 and df64)."""
    from lilac_tpu_torch.generate.random_crs import random_crs
    from lilac_tpu_torch.kernels.routed_spmv import build_routed_csr
    from lilac_tpu_torch.plan import SpmvPlan

    indptr, indices, data, shape = random_crs(size, seed=0)
    walls = {}
    for kernel in ("xla_ell", "xla_sell", "xla_csr"):
        t0 = time.perf_counter()
        SpmvPlan(indptr, indices, data, shape, dtype="f32", kernel=kernel, device=device)
        synchronize(device)
        walls[kernel] = time.perf_counter() - t0
        print(f"  plan build ({kernel}): {walls[kernel]:.3f}s "
              f"(the reference's *-slow backends re-marshal this every call)")
    # routed plans are this framework's real marshalling cost (the SparseX
    # spx_mat_tune trade, sparsex.c:68-70): the whole network construction
    for dtype in ("f32", "df64"):
        t0 = time.perf_counter()
        build_routed_csr(indptr, indices, data, shape, dtype=dtype, device=device)
        synchronize(device)
        walls[f"routed/{dtype}"] = time.perf_counter() - t0
        print(f"  plan build (routed/{dtype}): {walls[f'routed/{dtype}']:.3f}s"
              " (plan-time tuning; disk-cacheable via save_routed)")
    return walls


def spmv_roofline(sizes, kernels, device="cuda", reps: int = 50) -> list:
    """For random_crs(size, seed=1) through each kernel, f32: a matvec's
    time in a chain of `reps`, its rates, its traffic's share of the HBM
    peak (none where the traffic fits the card's L2: such a chain reads from
    L2, and the row says `l2_resident`), and on the card the plan's own
    stage schedule replayed (measure_plan_stage_time) as a share of the
    matvec. Returns one dict a row."""
    from lilac_tpu_torch.generate.random_crs import random_crs
    from lilac_tpu_torch.plan import SpmvPlan
    from lilac_tpu_torch.utils.profiling import (
        chip_spec,
        l2_bytes,
        measure_plan_stage_time,
        measure_stage_roofline,
        roofline,
        spmv_traffic_bytes,
        timed_chain,
    )

    dev = torch.device(device)
    spec = chip_spec(dev)
    l2 = l2_bytes(dev)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {name}  HBM ceiling {spec['hbm_gbps']} GB/s  L2 {l2} bytes")
    on_card = dev.type == "cuda"
    if on_card:  # K1's stage rate, the faster of two network sizes
        best = max((measure_stage_roofline(m=1 << 17, S=48, device=dev),
                    measure_stage_roofline(m=1 << 18, S=96, device=dev)),
                   key=lambda p: p["stage_elems_per_s"])
        print("stage roofline (measured, routed kernel K1): "
              f"{best['stage_elems_per_s'] / 1e9:.2f} Gstage-elem/s "
              f"({best['ns_per_stage_elem'] * 1e3:.3f} ps/stage-elem at "
              f"m=2^{int(np.log2(best['m']))} S={best['S']})")
    rows = []
    for size in sizes:
        indptr, indices, data, shape = random_crs(size, seed=1)
        for kernel in kernels:
            plan = SpmvPlan(indptr, indices, data, shape, dtype="f32", kernel=kernel,
                            device=dev)
            x = plan.vec_in(np.random.default_rng(0).normal(size=shape[1]))
            t = timed_chain(lambda v, plan=plan: plan.matvec_with(plan.A, v), x, reps)
            tb = spmv_traffic_bytes(plan)
            r = roofline(tb["total"], 2.0 * plan.nnz, t, dev)
            row = dict(n=shape[0], nnz=plan.nnz, kernel=plan.kernel, ms=t * 1e3,
                       mnnz_s=plan.nnz / t / 1e6, ns_nnz=t / plan.nnz * 1e9,
                       gbps=r["gbps"], traffic_bytes=tb["total"],
                       b_nnz=tb["total"] / plan.nnz,
                       l2_resident=tb["total"] < l2,
                       frac_hbm=None if tb["total"] < l2 else r["frac_hbm"],
                       stage_floor_ms=None, stage_share=None)
            if on_card:
                floor = measure_plan_stage_time(plan, reps=reps)
                if floor is not None:
                    row["stage_floor_ms"] = floor * 1e3
                    row["stage_share"] = floor / t
            share = ("l2_resident" if row["l2_resident"]
                     else f"{row['frac_hbm']:.1%} of HBM roofline")
            stage = ("" if row["stage_share"] is None else
                     f"; stage floor {row['stage_floor_ms']:.3f} ms ="
                     f" {row['stage_share']:.1%} of matvec")
            print(f"  n={shape[0]:>8d} nnz={plan.nnz:>9d} kernel={plan.kernel:9s}"
                  f" {row['ms']:7.3f} ms  {row['mnnz_s']:8.1f} Mnnz/s"
                  f"  {row['ns_nnz']:6.3f} ns/nnz"
                  f"  {row['gbps']:6.1f} GB/s ({share};"
                  f" {row['b_nnz']:.1f} B/nnz streamed{stage})", flush=True)
            rows.append(row)
            del plan
    return rows


def spgemm(sizes, mean_nnz: float = 8.0, device="cuda") -> list:
    """C = A·B for A, B = random_crs(size, seed 3 / 4): the host expansion
    (expand_csr), ESC on `device` and, where n·n <= 64 M, the densified
    product; seconds each and whether ESC's structure is the host's."""
    from lilac_tpu_torch.generate.random_crs import random_crs
    from lilac_tpu_torch.ops import spgemm as sg

    rows = []
    for size in sizes:
        a = random_crs(size, seed=3, mean_nnz=mean_nnz, std_nnz=mean_nnz / 2)
        b = random_crs(size, seed=4, mean_nnz=mean_nnz, std_nnz=mean_nnz / 2)
        n = a[3][0]
        acsr, bcsr = a[:3], b[:3]
        t0 = time.perf_counter()
        ref = sg.expand_csr(acsr, bcsr, a[3], b[3])
        t_host = time.perf_counter() - t0
        t0 = time.perf_counter()
        esc = sg.esc_spgemm(acsr, bcsr, a[3], b[3], device=device)
        t_esc = time.perf_counter() - t0
        ok = bool(np.array_equal(esc[0], ref[0]) and np.array_equal(esc[1], ref[1]))
        row = dict(n=n, nnz_a=len(a[1]), nnz_c=len(ref[1]), host_s=t_host,
                   esc_s=t_esc, struct_match=ok, masked_dense_s=None)
        line = (f"  n={n:>8d} nnzA={len(a[1]):>9d} nnzC={len(ref[1]):>9d}"
                f"  host {t_host:7.3f}s  esc(device) {t_esc:7.3f}s"
                f"  struct_match={ok}")
        if n * n <= SPGEMM_DENSE_MAX:  # the densified path only where it fits
            t0 = time.perf_counter()
            sg.masked_dense(acsr, bcsr, a[3], b[3], device=device)
            row["masked_dense_s"] = time.perf_counter() - t0
            line += f"  masked-dense {row['masked_dense_s']:7.3f}s"
        print(line, flush=True)
        rows.append(row)
    return rows


def ingest(n: int = 1_000_000, avg_deg: float = 13.0, fmt: str = "mtx",
           kernel: str = "auto", iters: int = 64, device="cuda") -> dict:
    """A power-law graph written once to the data directory, then timed from
    disk: read, plan (PageRank's scaled columns, reuse="many") and `iters`
    PageRank iterations. Returns the walls, the arrays read, the plan's
    kernel and PageRank's x."""
    from lilac_tpu_torch.config import cfg
    from lilac_tpu_torch.generate.graphs import powerlaw_graph
    from lilac_tpu_torch.io import readers
    from lilac_tpu_torch.plan import SpmvPlan
    from lilac_tpu_torch.workloads import pagerank

    data_dir = cfg().resolved_data_dir()
    os.makedirs(data_dir, exist_ok=True)
    path = os.path.join(data_dir, f"ingest_{n}_{int(avg_deg)}.{fmt}")
    out = {"path": path, "write_s": None}
    if not os.path.exists(path):
        print(f"generating + writing {path} (one-time)…", flush=True)
        g = powerlaw_graph(n, avg_deg=avg_deg, seed=7)
        t0 = time.perf_counter()
        writer = readers.write_matrix_market if fmt == "mtx" else readers.write_sparsebench_crs
        writer(path, *g)
        out["write_s"] = time.perf_counter() - t0
        print(f"  write: {out['write_s']:.1f}s ({os.path.getsize(path)/1e6:.0f} MB)")
    t0 = time.perf_counter()
    reader = readers.read_matrix_market if fmt == "mtx" else readers.read_sparsebench_crs
    indptr, indices, vals, shape = reader(path)
    out["read_s"] = t_read = time.perf_counter() - t0
    nnz = len(indices)
    print(f"  read:  {t_read:.2f}s  ({nnz} nnz, "
          f"{os.path.getsize(path)/1e6/t_read:.0f} MB/s)")
    t0 = time.perf_counter()
    scaled = pagerank.normalise_columns(indptr, indices, vals, shape) * 0.85
    plan = SpmvPlan(indptr, indices, scaled, shape, dtype="f32", kernel=kernel,
                    reuse="many", device=device)
    synchronize(device)
    out["plan_s"] = t_plan = time.perf_counter() - t0
    print(f"  plan:  {t_plan:.2f}s  (kernel={plan.kernel})")
    t0 = time.perf_counter()
    r = pagerank.run(indptr, indices, vals, shape, iters=iters, runs=1, plan=plan)
    out["solve_s"] = t_solve = time.perf_counter() - t0
    print(f"  solve: {t_solve:.2f}s  (pagerank x{iters}, err={r.error:.3e})")
    print(f"  total: {t_read+t_plan+t_solve:.2f}s read->plan->solve")
    out.update(arrays=(indptr, indices, vals, shape), kernel=plan.kernel, x=r.x,
               error=r.error)
    return out


if __name__ == "__main__":
    sys.exit(main())
