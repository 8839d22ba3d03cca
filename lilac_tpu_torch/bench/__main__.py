"""CLI: python -m lilac_tpu_torch.bench {run,analyze}; see bench/__init__.py.

The reference's other subcommands (devices, config, marshall,
spmv-roofline, graph-scale, ingest, autotune-*) come with ROADMAP.md
Queue 1 item 7."""

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

    args = p.parse_args(argv)
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


if __name__ == "__main__":
    sys.exit(main())
