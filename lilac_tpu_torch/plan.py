"""Operator plans: one object that owns a staged operator and its vector
conversions.

Counterpart of lilac_tpu/plan.py. This slice carries FactoredNPBPlan; the
general SpmvPlan and its kernel selector are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from lilac_tpu_torch.ops import dfloat as df


class FactoredNPBPlan:
    """Plan for the factored NPB operator (kernels/factored.py), built from
    the class name. ``device`` is where the operator and its vectors live."""

    def __init__(self, class_name: str, *, dtype: str = "f64", device="cuda"):
        from lilac_tpu_torch.generate.npb import CLASSES
        from lilac_tpu_torch.kernels import factored as _f
        from lilac_tpu_torch.kernels.routed_spmv import (
            RoutedMat,
            RoutedMatHier,
            RoutedMatHierP,
        )

        cls = CLASSES[class_name.upper()]
        self.shape = (cls.na, cls.na)
        self.dtype = dtype
        self.device = torch.device(device)
        self.A, self.nnz = _f.build_factored(class_name, dtype=dtype, device=device)
        # label the sub-kernel serving the V / VT passes: "routed" = routing
        # networks through the CUDA kernels, "gather" = plain torch indexing
        routed = (RoutedMat, RoutedMatHier, RoutedMatHierP)
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
