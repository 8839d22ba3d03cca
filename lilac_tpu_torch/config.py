"""One declarative configuration surface for the port's runtime knobs.

Counterpart of lilac_tpu/config.py, holding only the knobs the ported
modules read. Each knob has a name, an env var, a type, a default and a
docstring. Env vars are the override mechanism, so ``cfg()`` re-reads the
environment on every call; knob reads are a few getenv calls, never
hot-path work. The env names are the JAX package's own.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


def _env(name, typ, default):
    raw = os.environ.get(name)
    if raw is None:
        return default
    if typ is bool:
        return raw not in ("", "0", "false", "False")
    if typ is Optional[int] or typ is int:
        return int(raw)
    if typ is float:
        return float(raw)
    return raw


@dataclasses.dataclass(frozen=True)
class Knob:
    attr: str
    env: str
    typ: object
    default: object
    doc: str


KNOBS = (
    Knob("data_dir", "LILAC_DATA_DIR", str, None,
         "Directory for generated matrices and routed-plan caches "
         "(default: <repo>/data/torch, so the two packages never race on "
         "one file; the formats are the same). LILAC_CACHE is an accepted "
         "alias."),
    Knob("net_mode", "LILAC_NET_MODE", str, "monotone",
         "Routing-network construction for single-table plans: 'monotone' "
         "= concentrate + interval-multicast shift phases (fewer stages; "
         "the broadcast phase folds away), 'benes' = Benes + "
         "run-broadcast schedule."),
    Knob("hier_bl", "LILAC_HIER_BL", Optional[int], None,
         "Hierarchical routed-network block length: the slots the inner "
         "pass keeps resident in shared memory (power of two >= 128). None "
         "= derived from the card's shared memory "
         "(kernels/routed.py:default_hier_bl: 2^13 on an H100). The JAX "
         "package's default, 2^16, fits a TPU's on-chip memory, not a "
         "thread block's."),
    Knob("hier_gmax", "LILAC_HIER_GMAX", Optional[int], None,
         "Butterfly group exponent for hierarchical plans (None = 3, the "
         "widest group the kernel takes: it holds nothing in shared "
         "memory). Each butterfly pass costs about one mask byte per slot "
         "whatever its stage count, so larger g = fewer passes = smaller "
         "plans and fewer streams through device memory."),
    Knob("steps_per_dispatch", "LILAC_STEPS_PER_DISPATCH", Optional[int], None,
         "NPB CG outer iterations between host read-backs of the zeta and "
         "rnorm histories (None = the whole loop, one read-back at the "
         "end)."),
    Knob("factored_segmode", "LILAC_FACTORED_SEGMODE", str, "auto",
         "Layout for the factored NPB operator: auto | routed | mixed | "
         "scan | single (auto = routed when the plan's device is CUDA, "
         "single on CPU). Routed plans are single-table up to n = 2^18 and "
         "hierarchical beyond; mixed keeps V as a hierarchical plan and "
         "applies V^T as a gather layout (JagELLT in df64), taken only when "
         "asked for ('mixed' with factored_vt=adj is 'routed'); scan is "
         "the column-segmented gather layout (SegELLScan)."),
    Knob("factored_vt", "LILAC_FACTORED_VT", str, "auto",
         "How the routed factored operator computes V^T u: 'plan' = stage "
         "a dedicated VT routed plan (two plans resident); 'adj' = run V's "
         "own network in reverse with add-merges (one plan, half the plan "
         "bytes). 'auto' = adj for the hierarchical classes (n > 2^18), "
         "plan for the single-table ones."),
    Knob("sb_transpose", "LILAC_SB_TRANSPOSE", str, "auto",
         "SparseBench BiCG Aᵀp operator: 'plan' = stage Aᵀ as its own "
         "forward plan (two plans resident), 'adj' = run the forward "
         "plan's network in reverse with add-merges (zero extra plan "
         "bytes, half the plan build/upload), 'auto' = adj for routed "
         "kernels."),
    Knob("seg_quantile", "LILAC_SEG_QUANTILE", float, 97.0,
         "Percentile of the (row, segment) run lengths that sets the one "
         "slab width of the scan layout (SegELLScan); longer runs spill "
         "into its tail."),
    Knob("autotune_model", "LILAC_AUTOTUNE_MODEL", str, None,
         "Path of a trained kernel-selection model JSON (default: "
         "lilac_tpu_torch/autotune/model.json, resolved from the package, "
         "trained on an H100's rows). A model serves only on the card its "
         "meta names and only if it passes the ship gate; elsewhere the "
         "heuristic serves."),
    Knob("bench_budget_s", "LILAC_BENCH_BUDGET_S", float, 480.0,
         "bench_npb wall budget in seconds; the class ladder stops before "
         "exceeding it."),
    Knob("bench_dtype", "LILAC_BENCH_DTYPE", str, "df64",
         "bench_npb value policy (df64 = verified f64-grade)."),
    Knob("bench_kernel", "LILAC_BENCH_KERNEL", str, "factored",
         "bench_npb operator (factored = V/VT routed factorization)."),
    Knob("bench_class", "LILAC_BENCH_CLASS", str, None,
         "Force one NPB class in bench_npb instead of the ladder."),
)


@dataclasses.dataclass
class Config:
    data_dir: Optional[str]
    net_mode: str
    hier_bl: Optional[int]
    hier_gmax: Optional[int]
    steps_per_dispatch: Optional[int]
    factored_segmode: str
    factored_vt: str
    sb_transpose: str
    seg_quantile: float
    autotune_model: Optional[str]
    bench_budget_s: float
    bench_dtype: str
    bench_kernel: str
    bench_class: Optional[str]

    @staticmethod
    def from_env() -> "Config":
        vals = {k.attr: _env(k.env, k.typ, k.default) for k in KNOBS}
        if vals["data_dir"] is None:  # legacy alias
            vals["data_dir"] = os.environ.get("LILAC_CACHE")
        return Config(**vals)

    def resolved_data_dir(self) -> str:
        if self.data_dir is not None:
            return os.path.abspath(self.data_dir)
        return os.path.abspath(
            os.path.join(os.path.dirname(__file__), "..", "data", "torch")
        )

    def describe(self) -> str:
        lines = []
        for k in KNOBS:
            v = getattr(self, k.attr)
            src = "env" if os.environ.get(k.env) is not None else "default"
            lines.append(f"{k.env:28s} = {v!r:20} [{src}]  {k.doc}")
        return "\n".join(lines)


def cfg() -> Config:
    """The live configuration (re-reads env, see module docstring)."""
    return Config.from_env()
