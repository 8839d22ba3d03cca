"""Operator plans: one object that owns a staged operator and its vector
conversions.

Counterpart of lilac_tpu/plan.py. SpmvPlan is built once from a host CSR
matrix: it chooses a kernel and its device format, packs and uploads the
buffers, and exposes the matvec closures; the matrix is immutable after
that (mutate the host data, build a new plan). FactoredNPBPlan stages the
factored NPB operator from a class name. ``device`` says where a plan's
operator and vectors live.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from lilac_tpu_torch.formats import convert
from lilac_tpu_torch.formats.sparse import ELL
from lilac_tpu_torch.kernels import gather as _gather  # noqa: F401  (registers kernels)
from lilac_tpu_torch.kernels import routed_spmv as _rs  # noqa: F401  (registers kernels)
from lilac_tpu_torch.kernels.registry import get_kernel
from lilac_tpu_torch.ops import dfloat as df
from lilac_tpu_torch.utils.profiling import BUILD, span

_PLAN = span("lilac.build.plan", BUILD)
_ROUTE = span("lilac.build.plan.route", BUILD)  # a routed plan built, not read
_MATVEC = span("lilac.operator.matvec")  # SpmvPlan's products, both directions
_ADJOINT = span("lilac.operator.adjoint")  # the registry transpose, in a matvec

ROUTED_KERNELS = ("routed", "routed_df", "routed_hier", "routed_hier_df")
_HOST_DTYPE = {"f32": np.float32, "f64": np.float64, "bf16": np.float32}
_VEC_DTYPE = {"f32": torch.float32, "f64": torch.float64, "bf16": torch.bfloat16}


class SpmvPlan:
    """Single-device plan for y = A x (and Aᵀx where the kernel has it).

    Parameters
    ----------
    indptr, indices, data : host CSR (0-based canonical), data float64/float32
    shape : (nrows, ncols)
    dtype : 'f32' | 'f64' | 'bf16' | 'df64' value policy on the device. bf16
        stores the matrix values in bfloat16 and serves the gather kernels
        only (the routed kernels move 4- and 8-byte words).
    kernel : 'auto' | a registry name (kernels/registry.py)
    reuse : 'once' | 'many'; a plan declared for many matvecs (iterative
        solvers, power methods) on a CUDA device routes instead of
        gathering, since the network's host build amortises over them
    cache_key : name of a routed plan file under the data directory, so a
        second plan of the same matrix loads instead of building
    device : where the operator and the vectors live
    """

    def __init__(
        self,
        indptr: np.ndarray,
        indices: np.ndarray,
        data: np.ndarray,
        shape: Tuple[int, int],
        *,
        dtype: str = "f32",
        kernel: str = "auto",
        reuse: str = "once",
        cache_key: str | None = None,
        device="cuda",
    ):
        counts = np.diff(indptr)
        self._describe(shape, dict(
            nrows=shape[0],
            nnz=int(len(indices)),
            max_row=int(counts.max()) if len(counts) else 0,
            mean_row=float(counts.mean()) if len(counts) else 0.0,
            std_row=float(counts.std()) if len(counts) else 0.0,
        ), dtype, reuse, device)
        if kernel == "auto":
            kernel = self._select_kernel()
        self.kernel = kernel
        dev = self.device

        if kernel == "xla_ell":
            self.A = convert.ell_device(indptr, indices, data, shape,
                                        dtype=_HOST_DTYPE[dtype], row_pad=8, device=dev)
        elif kernel == "xla_ell_df":
            v, c = convert.csr_to_ell_arrays(
                indptr, indices, df.split_f64_np(data), shape, row_pad=8)
            self.A = ELL(data=torch.as_tensor(v, device=dev),
                         indices=torch.as_tensor(c, dtype=torch.int64, device=dev),
                         shape=self.shape)
        elif kernel == "xla_csr":
            self.A = convert.csr_device(indptr, indices, data, shape,
                                        dtype=_HOST_DTYPE[dtype], device=dev)
        elif kernel == "xla_sell":
            self.A = convert.bucket_ell_device(indptr, indices, data, shape,
                                               dtype=_HOST_DTYPE[dtype], device=dev)
        elif kernel == "xla_sell_df":
            self.A = convert.bucket_ell_device(
                indptr, indices, df.split_f64_np(data), shape, device=dev)
        elif kernel in ROUTED_KERNELS:
            if dtype == "bf16":
                raise ValueError("the bf16 policy serves the gather kernels only")
            self._set_routed(self._routed(indptr, indices, data, kernel, cache_key),
                             kernel)
        else:
            raise ValueError(f"kernel {kernel!r} not wired into SpmvPlan")

        if dtype == "bf16":
            self.A = _cast_floating(self.A, torch.bfloat16)

    @classmethod
    def read(cls, cache_key: str, shape, row_stats: dict, *, dtype: str = "f32",
             kernel: str = "routed", device="cuda"):
        """The routed plan of a matrix read from the plan file `cache_key`
        names, without the matrix: `row_stats` are the matrix's, as a plan
        built from it holds them. None where the file is missing, unreadable
        or holds another shape."""
        if kernel not in ROUTED_KERNELS or dtype == "bf16":
            raise ValueError(f"only a routed plan is read from its file, not {kernel!r}")
        self = cls.__new__(cls)
        self._describe(shape, row_stats, dtype, "once", device)
        A = self._read_routed(self._routed_file(kernel, cache_key)[0])
        if A is None:
            return None
        self._set_routed(_rs.maybe_pack_hier(A, self.device), kernel)
        return self

    def _describe(self, shape, row_stats, dtype, reuse, device) -> None:
        if dtype not in ("f32", "f64", "bf16", "df64"):
            raise ValueError(f"unknown value policy {dtype!r}")
        self.reuse = reuse
        self.shape = tuple(shape)
        self.nnz = int(row_stats["nnz"])
        self.dtype = dtype
        self.device = torch.device(device)
        self.row_stats = dict(row_stats)

    def _set_routed(self, A, kernel: str) -> None:
        self.A = A
        vdt = "df64" if self.dtype == "df64" or kernel.endswith("_df") else self.dtype
        base = "routed_hier" if isinstance(A, _rs.RoutedMatHierP) else "routed"
        self.kernel = base + ("_df" if vdt == "df64" else "")

    def _routed_file(self, kernel, cache_key):
        """(plan file path, value type, hierarchical) of a routed plan: a
        single table up to 2^18 columns, hierarchical networks beyond (or
        when asked for)."""
        from lilac_tpu_torch.config import cfg

        vdt = "df64" if self.dtype == "df64" or kernel.endswith("_df") else self.dtype
        hier = kernel.startswith("routed_hier") or self.shape[1] > _rs.SINGLE_TABLE_MAX
        if cache_key is None:
            return None, vdt, hier
        conf = cfg()
        ddir = conf.resolved_data_dir()
        os.makedirs(ddir, exist_ok=True)
        return os.path.join(ddir, f"plan_{cache_key}_{vdt}{_rs.plan_tag(conf, hier)}.npz"), vdt, hier

    def _read_routed(self, cache_path):
        """The routed plan from its file, unpacked; None where there is none
        of this shape (a stale or colliding cache_key must not compute with
        another matrix)."""
        if cache_path is None:
            return None
        loaded = _rs._load_plans([cache_path], self.device)
        if loaded is not None and tuple(loaded[0].shape) == self.shape:
            return loaded[0]
        return None

    def _routed(self, indptr, indices, data, kernel, cache_key):
        """The routed plan, loaded from its plan file when `cache_key` names
        one that holds this shape, else built (and saved there)."""
        cache_path, vdt, hier = self._routed_file(kernel, cache_key)
        A = self._read_routed(cache_path)
        if A is None:
            with _ROUTE(fence=self.device):
                if hier:
                    A = _rs.build_routed_csr_hier(indptr, indices, data, self.shape,
                                                  dtype=vdt, bl=_rs.hier_bl_cfg())
                else:
                    A = _rs.build_routed_csr(indptr, indices, data, self.shape,
                                             dtype=vdt, device=self.device)
                if cache_path is not None:
                    _rs.save_routed(cache_path, A)
        return _rs.maybe_pack_hier(A, self.device)

    def _select_kernel(self) -> str:
        """Kernel and format gate, in the reference's order
        (lilac_tpu/plan.py:175-212):

        1. a plan declared reuse="many" on a CUDA device with a single-table
           width routes: the network's host build amortises over its many
           matvecs;
        2. df64 takes the heuristic's df64 gather layout;
        3. the trained model's choice (autotune.predict), where one is
           installed, passes its ship gate and was trained on this plan's
           device (a model whose meta names another card, the shipped H100
           model on the CPU for one, is not asked); a routed label is
           ignored on the CPU (the plain versions are no measure of the
           card) and for bf16 (the routed kernels move 4- and 8-byte words);
        4. the heuristic: ELL for near-uniform rows, bucketed ELL where row
           lengths spread."""
        from lilac_tpu_torch import autotune

        s = self.row_stats
        if (self.reuse == "many" and self.device.type == "cuda"
                and self.shape[1] <= _rs.SINGLE_TABLE_MAX and self.dtype != "bf16"):
            return "routed_df" if self.dtype == "df64" else "routed"
        # plain ELL pads every row to the longest; bucketed ELL caps the
        # waste when row lengths are spread
        spread = s["max_row"] > 1.5 * max(s["mean_row"], 1.0) + 4
        if self.dtype == "df64":
            return "xla_sell_df" if spread else "xla_ell_df"
        choice = autotune.predict(s["nrows"], s["nnz"], s["mean_row"], s["std_row"],
                                  device=self.device)
        if choice is not None and not (choice.startswith("routed") and (
                self.device.type != "cuda" or self.dtype == "bf16")):
            return choice
        return "xla_sell" if spread else "xla_ell"

    # -- value conversion --------------------------------------------------

    def vec_in(self, x: np.ndarray):
        """Host f64 vector -> device value in the plan's dtype policy."""
        if self.dtype == "df64":
            return df.from_f64(np.asarray(x), device=self.device)
        return torch.as_tensor(np.asarray(x), device=self.device).to(_VEC_DTYPE[self.dtype])

    def vec_out(self, y) -> np.ndarray:
        if self.dtype == "df64":
            return df.to_f64(y)
        return y.detach().to(torch.float64).cpu().numpy()

    # -- matvecs -----------------------------------------------------------

    def matvec_with(self, A, x):
        """The matvec with the container passed explicitly."""
        with _MATVEC:
            return get_kernel(self.kernel).fn(A, x)

    def matvec_t_with(self, A, x):
        """y = Aᵀx through the registry's transpose slot. The routed kernels
        run their forward plan in reverse (kernels K7-K11); a gather kernel
        without a scatter-add transpose raises: stage Aᵀ as its own forward
        plan with transposed_plan()."""
        t = get_kernel(self.kernel).transpose
        if t is None:
            raise ValueError(
                f"kernel {self.kernel!r} has no registered transpose; use "
                "lilac_tpu_torch.plan.transposed_plan(...) to stage A^T as its "
                "own forward plan")
        with _MATVEC, _ADJOINT:
            return t(A, x)

    def matvec(self, x):
        return self.matvec_with(self.A, x)

    def matvec_t(self, x):
        return self.matvec_t_with(self.A, x)

    def __call__(self, x):
        return self.matvec(x)


def _cast_floating(A, dtype):
    """The container with every floating tensor (also inside tuples) cast."""
    import dataclasses

    def cast(v):
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            return v.to(dtype)
        if isinstance(v, tuple):
            return tuple(cast(u) for u in v)
        return v

    return dataclasses.replace(
        A, **{f.name: cast(getattr(A, f.name)) for f in dataclasses.fields(A)})


def transposed_plan(indptr, indices, data, shape, **kw) -> SpmvPlan:
    """Stage Aᵀ as its own forward SpmvPlan (host CSR -> CSC transpose), for
    kernels whose forward accumulation has no scatter form (df64 sums): both
    directions stay on the forward path, at the cost of a second plan."""
    rows = np.repeat(np.arange(shape[0], dtype=np.int64), np.diff(indptr))
    t_ip, t_ix, t_v = convert.coo_to_csr_arrays(
        indices, rows, data, (shape[1], shape[0]))
    return SpmvPlan(t_ip, t_ix, t_v, (shape[1], shape[0]), **kw)


class FactoredNPBPlan:
    """Plan for the factored NPB operator (kernels/factored.py), built from
    the class name. ``device`` is where the operator and its vectors live."""

    def __init__(self, class_name: str, *, dtype: str = "f64", device="cuda"):
        from lilac_tpu_torch.generate.npb import CLASSES
        from lilac_tpu_torch.kernels import factored as _f
        from lilac_tpu_torch.kernels.routed_spmv import (
            RoutedMat,
            RoutedMatHierP,
            RoutedMatSeg,
        )

        cls = CLASSES[class_name.upper()]
        self.shape = (cls.na, cls.na)
        self.dtype = dtype
        self.device = torch.device(device)
        with _PLAN(fence=self.device):
            self.A, self.nnz = _f.build_factored(class_name, dtype=dtype, device=device)
        # label the sub-kernel serving the V / VT passes: "routed" = routing
        # networks through the CUDA kernels, "gather" = plain torch indexing
        routed = (RoutedMat, RoutedMatHierP, RoutedMatSeg)
        v_routed = isinstance(self.A.V, routed)
        # how V^T is applied: "adj" = V's own plan run in reverse (no VT
        # plan is held), "plan" = a dedicated forward plan
        self.factored_vt = "adj" if self.A.VT is None else "plan"
        t_routed = v_routed if self.A.VT is None else isinstance(self.A.VT, routed)
        sub = ("routed" if v_routed and t_routed
               else "mixed" if v_routed or t_routed else "gather")
        self.kernel = f"factored_{sub}" + ("_df" if dtype == "df64" else "")

    def matvec_with(self, A, x):
        from lilac_tpu_torch.kernels import factored as _f

        if self.dtype == "df64":
            return _f.factored_spmv_df(A, x)
        return _f.factored_spmv(A, x)

    def matvec(self, x):
        return self.matvec_with(self.A, x)

    def vec_in(self, x):
        if self.dtype == "df64":
            return df.from_f64(np.asarray(x), device=self.device)
        tt = {"f32": torch.float32, "f64": torch.float64}[self.dtype]
        return torch.as_tensor(np.asarray(x), device=self.device).to(tt)

    def vec_out(self, y):
        if self.dtype == "df64":
            return df.to_f64(y)
        return y.detach().cpu().numpy().astype(np.float64)

    def __call__(self, x):
        return self.matvec(x)
