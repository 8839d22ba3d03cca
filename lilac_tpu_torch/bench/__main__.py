"""CLI: python -m lilac_tpu_torch.bench {run,analyze,graph-scale}; see
bench/__init__.py. `graph-scale` runs PageRank or BFS on a synthetic
scale-free graph (generate/graphs.py) through each kernel of --kernels.

The reference's other subcommands (devices, config, marshall,
spmv-roofline, ingest, autotune-*) come with ROADMAP.md Queue 1 item 7."""

from __future__ import annotations

import argparse
import sys

from lilac_tpu_torch import bench


def main(argv=None):
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

    pg = sub.add_parser("graph-scale")  # synthetic scale-free PageRank / BFS
    pg.add_argument("--n", type=int, default=1_000_000)
    pg.add_argument("--avg-deg", type=float, default=16.0)
    pg.add_argument("--iters", type=int, default=128)
    pg.add_argument("--kernels", default="auto,routed")
    pg.add_argument("--workload", default="pagerank", choices=["pagerank", "bfs"])

    args = p.parse_args(argv)
    if args.cmd == "graph-scale":
        return graph_scale(args)
    if args.cmd == "run":
        row = bench.run_bench(
            args.bench, args.size, args.impl, platform=args.platform, runs=args.runs
        )
        bench.append_rows(args.out, [row])
        print(",".join(row.csv()))
    else:
        recs = bench.tidy(args.csv)
        for (plat, b, impl), s in sorted(
            bench.geomean_speedups(recs, args.baseline).items()
        ):
            print(f"{plat:10s} {b:14s} {impl:16s} geomean speedup {s:8.3f}x")
    return 0


def graph_scale(args) -> int:
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
