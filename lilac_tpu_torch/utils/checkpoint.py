"""Checkpoint / resume for iterative solves.

Counterpart of lilac_tpu/utils/checkpoint.py. A state is a nest of tuples,
lists and dicts of tensors (and ops/dfloat.DF pairs); it is stored as one
.npz in the JAX package's layout: its leaves in order as `leaf_0`,
`leaf_1`, ..., and `__meta__`, the JSON {"meta": ..., "nleaves": ...} as
bytes. So either package reads the other's checkpoints. Leaves are
flattened in JAX's pytree order (dict keys sorted, DF as (hi, lo)) by a
small walker of the port's own.

The JAX package caches one jit closure per (plan, algebra, shift) for the
resumed chunks (`_JIT_CACHE`); eager torch compiles nothing, so
checkpointed_power_method calls npb_power_method directly.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from lilac_tpu_torch.ops import dfloat as df


def _flatten(state, out: List) -> None:
    if isinstance(state, df.DF):
        out += [state.hi, state.lo]
    elif isinstance(state, dict):
        for k in sorted(state):
            _flatten(state[k], out)
    elif isinstance(state, (tuple, list)):
        for v in state:
            _flatten(v, out)
    else:
        out.append(state)


def _unflatten(like, leaves):
    """A nest shaped like `like` with its leaves taken in order from the
    iterator `leaves`."""
    if isinstance(like, df.DF):
        return df.DF(next(leaves), next(leaves))
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_state(path: str, state, meta: Dict[str, Any]) -> None:
    """state: a nest of tensors (DF pairs included). Written to `path`
    through a temporary file, so a reader never sees half a checkpoint."""
    leaves: List = []
    _flatten(state, leaves)
    arrays = {f"leaf_{i}": _host(l) for i, l in enumerate(leaves)}
    arrays["__meta__"] = np.frombuffer(
        json.dumps(dict(meta=meta, nleaves=len(leaves))).encode(), dtype=np.uint8
    )
    tmp = path + ".tmp"
    np.savez(tmp, **arrays)
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)


def load_state(path: str, treedef_like, device="cuda") -> Tuple[Any, Dict[str, Any]]:
    """treedef_like: a nest of the same structure (values ignored). The
    leaves come back as tensors on `device`."""
    z = np.load(path)
    info = json.loads(bytes(z["__meta__"]).decode())
    leaves = [torch.as_tensor(z[f"leaf_{i}"], device=device)
              for i in range(info["nleaves"])]
    return _unflatten(treedef_like, iter(leaves)), info["meta"]


def checkpointed_power_method(
    plan, x0, shift: float, niter: int, *, path: str, every: int = 5, alg=None
):
    """NPB outer loop with a checkpoint every `every` steps; resumes when
    `path` exists. Returns (zeta_history, x_final, start_iter)."""
    from lilac_tpu_torch.solvers.algebra import get_algebra
    from lilac_tpu_torch.solvers.cg import npb_power_method

    alg = alg or get_algebra(plan.dtype, plan.device)
    start = 0
    zetas: list = []
    x = x0
    if os.path.exists(path):
        (x,), meta = load_state(path, (x0,), device=plan.device)
        start = meta["iter"]
        zetas = list(meta["zetas"])

    it = start
    while it < niter:
        step = min(every, niter - it)
        z, _r, x = npb_power_method(plan.matvec_with, alg, plan.A, x, shift, step)
        zetas.extend(_to_f64(z).tolist())
        it += step
        save_state(path, (x,), dict(iter=it, zetas=zetas))
    return np.asarray(zetas), x, start


def _to_f64(z) -> np.ndarray:
    if isinstance(z, df.DF):
        return df.to_f64(z)
    return z.detach().to(torch.float64).cpu().numpy()
