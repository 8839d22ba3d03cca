"""Driver of the configurations of kind ``sparsebench_bicg``: SparseBench's
timed BiCG (run_all at one size) through lilac_tpu_torch's main path,
``workloads/sparsebench.BenchSolver``, the solver its ``benchmark`` times.

Set-up builds (or loads) the solver's plan for the configuration's matrix
(the seed of the matrix is the configuration's, never the run's) and runs
the protocol's untimed warm-up solve. The window runs whole solves back to
back from x0 = 0 with the run's b, reading each solve's its, history and
last recurrence norm back at its end, and closes at the first solve end
after the window's seconds. The check runs the plain reference
(reference/sparsebench.py) once, since every solve starts from the same b,
and judges every solve's its and first norms against it; the last solve's
x is held to SparseBench's own oracle, its true residual ||b - A x||
(computed by the reference in f64) against the program's recurrence norm,
and the program's transpose product of that solve's last shadow direction
pl (its last iteration's input to A^T) to the reference's CSR A^T. The
reference's matrix is generated once a checkout and kept under
portbench/cache/reference.

b is the all-ones vector for seed 0 (run_all's) and float32 values drawn
from the seed otherwise (exact in f32, df64 and f64 alike). The program's
routed operator numbers its vectors by descending row length
(formats/convert.py:length_relabel_csr); b is handed to it in that
numbering, and the reference works the numbering out again from its own
matrix (reference.sparsebench.relabel) to run in the generator's.
"""

from __future__ import annotations

import gc
import os
import time

import numpy as np

from portbench import harness
from portbench.reference import sparsebench as ref
from portbench.yardstick import csr_roofline
from portbench.yardstick import trace as _trace

WORD_BYTES = {"f64": 8, "df64": 8, "f32": 4}


def start_vector(seed: int, n: int) -> np.ndarray:
    if seed == 0:
        return np.ones(n, dtype=np.float64)
    rng = np.random.default_rng(seed)
    return rng.uniform(0.5, 1.5, n).astype(np.float32).astype(np.float64)


def reference_csr(size: int, seed: int):
    """The reference's matrix (ref.random_crs), read from the file an
    earlier run of this checkout wrote, else generated and written."""
    path = os.path.join(harness.HERE, "cache", "reference", f"sb{size}s{seed}.npz")
    n = size**3
    try:
        with np.load(path) as z:
            return z["indptr"], z["indices"], z["data"], (n, n)
    except (OSError, KeyError, ValueError):
        pass
    csr = ref.random_crs(size, seed=seed)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    part = path + ".part"
    with open(part, "wb") as f:
        np.savez(f, indptr=csr[0], indices=csr[1], data=csr[2])
    os.replace(part, path)
    return csr


class Run:
    def __init__(self, cell, seed: int, device: str, readings, dtype: str = None):
        import torch

        from lilac_tpu_torch.workloads.sparsebench import BenchSolver

        self.torch = torch
        self.conf = cell.config
        self.dtype = dtype or cell.traffic["dtype"]
        self.wl = cell.workload
        self.device = device
        self.r = readings
        self._ref = None

        t0 = time.perf_counter()
        self.sol = BenchSolver(
            int(self.conf["size"]), maxit=int(self.conf["maxit"]),
            rtol=float(self.conf["rtol"]), dtype=self.dtype,
            seed=int(self.conf["matrix_seed"]), kernel=self.conf["impl"],
            sigma_relabel=bool(self.conf["sigma_relabel"]), device=device)
        self._sync()
        readings.spans["plan_build"] = time.perf_counter() - t0
        # the path under test: one hierarchical plan, A^T by it in reverse
        kernel = "routed_hier_df" if self.dtype == "df64" else "routed_hier"
        if self.sol.plan_t is not None or self.sol.plan.kernel != kernel:
            raise RuntimeError(
                f"the solver runs {self.sol.plan.kernel} with A^T "
                f"{'by its own plan' if self.sol.plan_t is not None else 'in reverse'}, "
                f"not {kernel} with A^T in reverse")
        self.n, self.nnz = self.sol.n, self.sol.nnz
        self.restart(seed)
        self.sol.solve(self.b)  # the protocol's untimed warm-up solve

    def restart(self, seed: int) -> None:
        """Make b from `seed`: the next window solves with it."""
        self.b_host = start_vector(seed, self.n)
        self.b = self.sol.plan.vec_in(self.b_host)

    def _sync(self):
        if self.device.startswith("cuda"):
            self.torch.cuda.synchronize()

    def window(self, seconds: float, steps_at_least: int = 0) -> None:
        """Solves from x0 until `seconds` have passed (and, for
        calibrate.py's control, `steps_at_least` iterations are done)."""
        sol, to_f64 = self.sol, self.sol.alg.to_f64
        solves = []
        iters, ops = 0, 0.0
        self._sync()
        t0 = time.perf_counter()
        while True:
            x, its, hist, rn = sol.solve(self.b)
            solves.append((its, hist.cpu().numpy(), float(to_f64(rn))))
            iters += abs(its)
            ops += sol.flops(its)
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds and iters >= steps_at_least:
                break
        self.x, self.pl = x, sol.pl
        self.solves = solves
        self.r.window_s = elapsed
        self.r.window_ops = ops
        self.r.counts["window_steps"] = iters
        self.r.counts["window_solves"] = len(solves)

    def trace(self) -> None:
        """The traced phase, after the window: the untraced wall of the
        first N iterations of a solve, the same N under the profiler, the
        untraced time of a product and of a transpose product, then M of
        each under the profiler with the L2 flushed before each."""
        torch, r, sol = self.torch, self.r, self.sol
        n, m = int(self.wl["profile_steps"]), int(self.wl["profile_products"])
        self._sync()
        t0 = time.perf_counter()
        sol.solve(self.b, stop_at=n)
        r.spans["steps_untraced"] = time.perf_counter() - t0
        r.counts["profiled_steps"] = n
        r.traces["steps"] = _trace.profile(lambda: sol.solve(self.b, stop_at=n), self._sync)

        ops = {"matvec": lambda: sol.matvec(sol.As, self.b),
               "adjoint": lambda: sol.matvec_t(sol.As, self.b)}
        for name, op in ops.items():
            self._sync()
            t0 = time.perf_counter()
            for _ in range(m):
                op()
            self._sync()
            r.spans[name + "_untraced"] = (time.perf_counter() - t0) / m

        flush = None
        if self.device.startswith("cuda"):
            l2 = torch.cuda.get_device_properties(0).L2_cache_size
            flush = torch.empty(4 * l2, dtype=torch.uint8, device=self.device)

        def products():
            for mark, op in (("product", ops["matvec"]), ("adjoint", ops["adjoint"])):
                for _ in range(m):
                    if flush is not None:
                        flush.bitwise_not_()
                    self._sync()
                    with torch.profiler.record_function(_trace.MARK + mark):
                        op()
                        self._sync()

        r.traces["products"] = _trace.profile(products, self._sync)
        r.counts["profiled_products"] = m
        least = csr_roofline.csr_spmv_bytes(self.n, self.nnz, WORD_BYTES[self.dtype])
        r.counts["spmv_least_bytes"] = least
        r.counts["adjoint_least_bytes"] = least

    def check(self, free: bool = True):
        """Free the program's state (unless `free` is False), run the
        reference once from the same b, and judge every solve of the
        window (its, the first norms), the last solve's x (its true
        residual) and the transpose product of its last pl."""
        Check, Verdict = harness.Check, harness.Verdict
        torch, sol = self.torch, self.sol
        x_prog = sol.plan.vec_out(self.x)
        pl_prog = sol.plan.vec_out(self.pl)
        adj_prog = sol.plan.vec_out(sol.matvec_t(sol.As, self.pl))
        del sol
        if free:
            del self.sol, self.x, self.pl, self.b
            gc.collect()
            if self.device.startswith("cuda"):
                torch.cuda.empty_cache()

        if self._ref is None:
            csr = reference_csr(int(self.conf["size"]), int(self.conf["matrix_seed"]))
            self._ref = (ref.relabel(csr[0]), ref.Operator(csr, self.device))
        sigma, op = self._ref
        b = np.empty(self.n)
        b[sigma] = self.b_host  # program position k holds row sigma[k]
        b = torch.as_tensor(b, device=self.device)
        _, its_ref, hist_ref = ref.bicg(
            op, b, int(self.conf["maxit"]), float(self.conf["rtol"]))
        x = np.empty(self.n)
        x[sigma] = x_prog
        true_res = ref.residual_norm(op, b, torch.as_tensor(x, device=self.device))
        pl, adj = np.empty(self.n), np.empty(self.n)
        pl[sigma], adj[sigma] = pl_prog, adj_prog
        adj_ref = op.matvec_t(torch.as_tensor(pl, device=self.device)).cpu().numpy()
        adj_rel = float(np.linalg.norm(adj - adj_ref) / np.linalg.norm(adj_ref))

        lim = self.wl["limits"]
        k = min(int(self.wl["hist_first"]), len(hist_ref))
        its_diff, hist_rel = [], []
        for its, hist, _ in self.solves:
            its_diff.append(float(abs(its - its_ref)))
            with np.errstate(divide="ignore", invalid="ignore"):
                hist_rel.append(float(np.max(
                    np.abs(hist[:k].astype(np.float64) - hist_ref[:k]) / hist_ref[:k])))
        its_diff, hist_rel = np.array(its_diff), np.array(hist_rel)
        bad = ~((its_diff <= lim["its_diff"]) & (hist_rel <= lim["hist_rel"]))
        true_gap = abs(true_res - self.solves[-1][2]) / true_res
        if not (true_gap <= lim["true_gap"] and adj_rel <= lim["adj_rel"]):
            bad[-1] = True  # the last solve produced x and pl
        return Verdict(
            attempted=len(self.solves),
            failed=int(bad.sum()),
            checks=[
                Check("its_diff", float(np.max(its_diff)), lim["its_diff"]),
                Check("hist_rel", float(np.max(hist_rel)), lim["hist_rel"]),
                Check("true_gap", true_gap, lim["true_gap"]),
                Check("adj_rel", adj_rel, lim["adj_rel"]),
            ],
        )
