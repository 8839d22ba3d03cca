"""Driver of the configurations of kind ``npb_cg``: NPB CG's inverse power
iteration (cg.f:233-349) through lilac_tpu_torch's main path.

Set-up builds (or loads) ``plan.FactoredNPBPlan`` for the class and the
algebra of ``solvers.algebra.get_algebra``, as ``workloads/npb_cg.run``
does, and runs NPB's untimed warm-up step from x0. The window restarts
from x0 and runs ``solvers.cg.npb_power_method`` a chunk of outer steps at
a time, reading the zeta and rnorm histories back at each chunk's end, and
closes at the first chunk end after the window's seconds. The check runs
the plain reference (reference/npb.py) over as many steps from the same
x0 and compares every step's zeta and rnorm and the last x.

x0 is NPB's all-ones vector for seed 0 and a positive vector of float32
values drawn from the seed otherwise (exact in f32, df64 and f64 alike).
The program's routed operator numbers its vectors by descending column
count (lilac_tpu_torch/kernels/factored.py); x0 is handed to it in that
numbering, and the reference works the numbering out again from its own
makea (reference.npb.relabel) to run in NPB's.
"""

from __future__ import annotations

import gc
import time

import numpy as np

from portbench.reference import npb as ref
from portbench.yardstick import roofline
from portbench.yardstick import trace as _trace

WORD_BYTES = {"f64": 8, "df64": 8, "f32": 4}


def npb_class(conf: dict) -> ref.NPBClass:
    return ref.NPBClass(conf["class"], int(conf["na"]), int(conf["nonzer"]),
                        int(conf["niter"]), float(conf["shift"]),
                        float(conf["rcond"]), float(conf["zeta_verify"]))


def ops_per_step(cls: ref.NPBClass) -> float:
    """NPB's operation count of one outer step (cg.f:395-402)."""
    t = float(cls.nonzer * (cls.nonzer + 1))
    return 2.0 * cls.na * (3.0 + t + 25.0 * (5.0 + t) + 3.0)


def start_vector(seed: int, na: int) -> np.ndarray:
    if seed == 0:
        return np.ones(na, dtype=np.float64)
    rng = np.random.default_rng(seed)
    return rng.uniform(0.5, 1.5, na).astype(np.float32).astype(np.float64)


class Run:
    def __init__(self, cell, seed: int, device: str, readings, dtype: str = None):
        import torch

        from lilac_tpu_torch.plan import FactoredNPBPlan
        from lilac_tpu_torch.solvers.algebra import get_algebra
        from lilac_tpu_torch.solvers.cg import npb_power_method

        self.torch = torch
        self.cls = npb_class(cell.config)
        self.dtype = dtype or cell.traffic["dtype"]
        self.chunk = int(cell.traffic["steps_per_chunk"])
        self.wl = cell.workload
        self.device = device
        self.r = readings
        self._triples = self._ref = None

        t0 = time.perf_counter()
        self.plan = FactoredNPBPlan(self.cls.name, dtype=self.dtype, device=device)
        self._sync()
        readings.spans["plan_build"] = time.perf_counter() - t0
        self.alg = get_algebra(self.dtype, device=device)
        self.power = npb_power_method
        self.restart(seed)
        self._steps(self.x0, 1)  # NPB's untimed warm-up step (cg.f:233-272)

    def restart(self, seed: int) -> None:
        """Make x0 from `seed`: the next window starts from it."""
        self.x0_host = start_vector(seed, self.cls.na)
        self.x0 = self.plan.vec_in(self.x0_host)

    def _sync(self):
        if self.device.startswith("cuda"):
            self.torch.cuda.synchronize()

    def _steps(self, x, n):
        """n outer steps from x, histories read back: (zetas, rnorms, x)."""
        zetas, rnorms, x = self.power(self.plan.matvec_with, self.alg, self.plan.A,
                                      x, self.cls.shift, n)
        return self.alg.to_f64(zetas), self.alg.to_f64(rnorms), x

    def window(self, seconds: float, steps_at_least: int = 0) -> None:
        """Chunks of steps from x0 until `seconds` have passed (and, for
        calibrate.py's control, `steps_at_least` steps are done)."""
        zs, rs = [], []
        x = self.x0
        steps = 0
        self._sync()
        t0 = time.perf_counter()
        while True:
            z, rn, x = self._steps(x, self.chunk)
            self._sync()
            zs.append(z)
            rs.append(rn)
            steps += self.chunk
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds and steps >= steps_at_least:
                break
        self.x = x
        self.zetas = np.concatenate(zs)
        self.rnorms = np.concatenate(rs)
        self.r.window_s = elapsed
        self.r.window_ops = ops_per_step(self.cls) * steps
        self.r.counts["window_steps"] = steps

    def triples(self):
        if self._triples is None:
            self._triples = ref.makea_triples(self.cls.na, self.cls.nonzer)
        return self._triples

    def trace(self) -> None:
        """The traced phase, after the window: the untraced wall of the
        profiled steps, the steps under the profiler, the untraced time of
        a product, then the products under the profiler with the L2 flushed
        before each."""
        torch, r = self.torch, self.r
        n, m = int(self.wl["profile_steps"]), int(self.wl["profile_products"])
        x = self.x
        self._sync()
        t0 = time.perf_counter()
        self._steps(x, n)
        self._sync()
        r.spans["steps_untraced"] = time.perf_counter() - t0
        r.counts["profiled_steps"] = n
        r.traces["steps"] = _trace.profile(lambda: self._steps(x, n), self._sync)

        self._sync()
        t0 = time.perf_counter()
        for _ in range(m):
            self.plan.matvec(x)
        self._sync()
        r.spans["matvec_untraced"] = (time.perf_counter() - t0) / m

        flush = None
        if self.device.startswith("cuda"):
            l2 = torch.cuda.get_device_properties(0).L2_cache_size
            flush = torch.empty(4 * l2, dtype=torch.uint8, device=self.device)

        def products():
            for _ in range(m):
                if flush is not None:
                    flush.bitwise_not_()
                self._sync()
                with torch.profiler.record_function(_trace.MARK + "product"):
                    self.plan.matvec(x)
                    self._sync()

        r.traces["products"] = _trace.profile(products, self._sync)
        r.counts["profiled_products"] = m
        r.counts["spmv_least_bytes"] = roofline.factored_spmv_bytes(
            self.triples()[0], WORD_BYTES[self.dtype])

    def check(self, free: bool = True):
        """Free the program's state (unless `free` is False), run the
        reference over the window's steps from the same x0, and judge every
        step."""
        from portbench.harness import Check, Verdict

        torch = self.torch
        x_prog = self.plan.vec_out(self.x)
        if free:
            del self.plan, self.x, self.x0, self.alg
            gc.collect()
            if self.device.startswith("cuda"):
                torch.cuda.empty_cache()

        if self._ref is None:
            nzv, ivc, vc = self.triples()
            self._ref = (ref.relabel(ivc, self.cls.na),
                         ref.Operator(self.cls, (nzv, ivc, vc), self.device))
        sigma, op = self._ref
        x0 = np.empty(self.cls.na)
        x0[sigma] = self.x0_host  # program position k holds column sigma[k]
        steps = len(self.zetas)
        z_ref, rn_ref, x_ref = ref.power_method(
            op, torch.as_tensor(x0, device=self.device), self.cls.shift, steps)
        x_ref = x_ref.cpu().numpy()[sigma]

        lim = self.wl["limits"]
        with np.errstate(divide="ignore", invalid="ignore"):
            zeta_rel = np.abs(self.zetas - z_ref) / np.abs(z_ref)
            rnorm_ratio = np.maximum(self.rnorms / rn_ref, rn_ref / self.rnorms)
        x_rel = float(np.max(np.abs(x_prog - x_ref)) / np.max(np.abs(x_ref)))
        bad = ~((zeta_rel <= lim["zeta_rel"]) & (rnorm_ratio <= lim["rnorm_ratio"]))
        if not x_rel <= lim["x_rel"]:
            bad[-1] = True  # the last step produced x
        return Verdict(
            attempted=steps,
            failed=int(bad.sum()),
            checks=[
                Check("zeta_rel", float(np.max(zeta_rel)), lim["zeta_rel"]),
                Check("rnorm_ratio", float(np.max(rnorm_ratio)), lim["rnorm_ratio"]),
                Check("x_rel", x_rel, lim["x_rel"]),
            ],
        )
