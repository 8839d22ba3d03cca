"""Benchmark runs and analysis: the suite's run_all / results pipeline.

Counterpart of lilac_tpu/bench/__init__.py. The reference suite runs each
workload 5 times per (platform, impl, size) and appends CSV rows
`platform,bench,impl,size,t1..t5` (NPB3.3.1/run_all:31-38), then melts and
geomeans them (results/ics/tidy.py:6-17, analysis.py:7-27). This module
keeps that CSV schema and the numpy tidy / geomean analysis, so rows of an
H100 run and of a TPU run sit in one file and `analyze` compares them.
`impl` values are the kernel registry's names (kernels/registry.py) or a
workload's own kernel option.

CLI:  python -m lilac_tpu_torch.bench run --bench sgemm --size 4096
      python -m lilac_tpu_torch.bench run --bench sparsebench --size 160 --impl routed
      python -m lilac_tpu_torch.bench analyze all.csv --baseline xla_ell
"""

from __future__ import annotations

import csv
import dataclasses
from typing import Callable, Dict, List, Sequence

import numpy as np

CSV_FIELDS = ["platform", "bench", "impl", "size"]  # + t1..tN


@dataclasses.dataclass
class BenchRow:
    platform: str
    bench: str
    impl: str
    size: str
    times: List[float]

    def csv(self) -> List[str]:
        return [self.platform, self.bench, self.impl, self.size] + [
            f"{t:.6f}" for t in self.times
        ]


# ---------------------------------------------------------------------------
# benchmark registry: each entry returns seconds for one run
# ---------------------------------------------------------------------------


def _run_npb(size: str, impl: str) -> float:
    from lilac_tpu_torch.workloads import npb_cg

    kernel = "factored" if impl in ("factored", "auto") else impl
    r = npb_cg.run(size, dtype="df64", kernel=kernel)
    if not r.verified and r.rel_err > 1e-8:
        raise RuntimeError(f"NPB {size} failed verification: {r.rel_err}")
    return r.time_s


def _run_sparsebench(size: str, impl: str) -> float:
    from lilac_tpu_torch.workloads import sparsebench

    if int(size) >= 40:  # timed benchmark protocol (run_all sizes 40-160)
        return sparsebench.benchmark(int(size), kernel=impl).time_s
    return sparsebench.run_case("s", int(size), 2, 0).time_s


def _run_parboil_spmv(size: str, impl: str) -> float:
    import os

    from lilac_tpu_torch.config import cfg
    from lilac_tpu_torch.workloads import parboil_spmv as pv

    # Parboil's datasets are not part of this repository: a copy (or link)
    # of the suite's checkout at <data dir>/parboil holds datasets/spmv/<size>/
    root = os.path.join(cfg().resolved_data_dir(), "parboil")
    if not os.path.isdir(root):
        raise RuntimeError(
            f"parboil-spmv reads Parboil's datasets from {root} (datasets/spmv/"
            "<size>/): place or link the suite's checkout there")
    r = pv.run_dataset(size, root, kernel=impl)
    if r.matched is False:
        raise RuntimeError("parboil output mismatch")
    return r.time_s


def _run_sgemm(size: str, impl: str) -> float:
    from lilac_tpu_torch.workloads import sgemm

    n = int(size)
    rng = np.random.default_rng(0)
    A = rng.normal(size=(n, n)).astype(np.float32)
    BT = rng.normal(size=(n, n)).astype(np.float32)
    _, res = sgemm.run_arrays(A, BT, kernel=impl)
    return res.time_s


def _not_ported(bench: str, item: str) -> Callable[[str, str], float]:
    def run(size: str, impl: str) -> float:
        raise NotImplementedError(
            f"bench {bench!r} is not ported yet (ROADMAP.md Queue 1 item {item})")
    return run


BENCHES: Dict[str, Callable[[str, str], float]] = {
    "npb": _run_npb,
    "sparsebench": _run_sparsebench,
    "pagerank": _not_ported("pagerank", "3"),
    "pathsample": _not_ported("pathsample", "4"),
    "parboil-spmv": _run_parboil_spmv,
    "sgemm": _run_sgemm,
}


def run_bench(
    bench: str, size: str, impl: str = "auto", *, platform: str = "gpu", runs: int = 5
) -> BenchRow:
    fn = BENCHES[bench]
    times = [fn(size, impl) for _ in range(runs)]
    return BenchRow(platform, bench, impl, size, times)


def append_rows(path: str, rows: Sequence[BenchRow]) -> None:
    with open(path, "a", newline="") as f:
        w = csv.writer(f)
        for r in rows:
            w.writerow(r.csv())


# ---------------------------------------------------------------------------
# analysis (tidy.py + analysis.py semantics, numpy-only)
# ---------------------------------------------------------------------------


def tidy(csv_path: str) -> List[dict]:
    """Melt the t1..tN columns into long form (results/ics/tidy.py:6-17)."""
    out = []
    with open(csv_path, newline="") as f:
        for row in csv.reader(f):
            if not row:
                continue
            platform, bench, impl, size = row[:4]
            for i, t in enumerate(row[4:], 1):
                out.append(dict(platform=platform, bench=bench, impl=impl,
                                size=size, run=i, time=float(t)))
    return out


def geomean_speedups(records: List[dict], baseline: str) -> Dict[tuple, float]:
    """Per (platform, bench, impl): geometric-mean speedup over `baseline`
    across matching sizes, from each group's fastest run
    (results/ics/analysis.py:7-27)."""
    best: Dict[tuple, float] = {}
    for r in records:
        key = (r["platform"], r["bench"], r["impl"], r["size"])
        best[key] = min(best.get(key, np.inf), r["time"])
    out: Dict[tuple, List[float]] = {}
    for (plat, bench, impl, size), t in best.items():
        base = best.get((plat, bench, baseline, size))
        if base is None or impl == baseline:
            continue
        out.setdefault((plat, bench, impl), []).append(base / t)
    return {
        k: float(np.exp(np.mean(np.log(np.asarray(v))))) for k, v in out.items() if v
    }
