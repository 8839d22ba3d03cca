"""run_spmd: one function run by every rank of a torch.distributed group.

The counterpart of running one shard_map program over a mesh
(lilac_tpu/parallel/dist.py). `run_spmd(fn, nprocs, *args, backend=...)`

* builds the CUDA libraries in the caller first, where the ranks run on
  the card (kernels/_cuda.py; otherwise each rank would compile the same
  sources);
* starts `nprocs` processes with the spawn start method;
* initialises their group through a FileStore in a temporary directory of
  its own (processes running at the same time never meet on a port), with
  a timeout on every collective;
* calls `fn(mesh, *args)` in each rank, `mesh` from parallel.mesh.make_mesh;
* returns every rank's result in rank order, tensors as numpy arrays.

`fn` must be a module-level function of a module that imports no JAX: each
spawned rank imports it afresh. `fn` and its arguments are pickled once
into one file of the temporary directory, which every rank reads: large
inputs go as arrays built once by the caller, never generated again in
each rank (and a rank's start does not wait on a pipe of them).

A rank that raises fails the run: the caller raises with that rank's
traceback and ends the other ranks at once. A rank that dies without a
word does the same. A rank waiting on a dead peer fails within the group's
timeout. Ranks use one PyTorch CPU thread each, so that several ranks on
one host do not oversubscribe its cores.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import queue
import shutil
import tempfile
import traceback

import numpy as np
import torch
import torch.distributed as dist

from lilac_tpu_torch.parallel.mesh import make_mesh, transport_of

DEFAULT_TIMEOUT_S = 300.0
_JOIN_S = 60.0


def _to_host(obj):
    """Results cross the process boundary as numpy arrays and Python values
    (a tensor pickled between processes would need its sender alive)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to_host(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    return obj


def _rank_main(rank, size, tmp, backend, device, timeout_s, results):
    torch.set_num_threads(1)
    try:
        with open(os.path.join(tmp, "call.pkl"), "rb") as f:
            fn, args = pickle.load(f)  # written by run_spmd for this run
        store_path = os.path.join(tmp, "store")
        if backend == "nccl":
            torch.cuda.set_device(rank)
        store = dist.FileStore(store_path, size)
        dist.init_process_group(backend, store=store, rank=rank, world_size=size,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            mesh = make_mesh(size, backend=backend, device=device)
            out = _to_host(fn(mesh, *args))
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the caller, which raises it
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def run_spmd(fn, nprocs: int, *args, backend: str, device="cuda",
             timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Run fn(mesh, *args) on `nprocs` ranks of a new `backend` group
    ("nccl": one rank per card; "gloo": the host transport) with tensors on
    `device`; returns the ranks' results in rank order."""
    transport_of(backend, nprocs)
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("run_spmd: device 'cuda' but no CUDA device is visible")
        from lilac_tpu_torch.kernels import _cuda

        _cuda.build_all()
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="lilac_spmd_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, name=f"lilac-rank-{r}", args=(
        r, nprocs, tmp, backend, str(device), timeout_s, results)) for r in range(nprocs)]
    got: dict = {}
    failed = True
    try:
        with open(os.path.join(tmp, "call.pkl"), "wb") as f:
            pickle.dump((fn, args), f, protocol=pickle.HIGHEST_PROTOCOL)
        for p in procs:
            p.start()
        while len(got) < nprocs:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"run_spmd: rank {dead[0][0]} exited with code "
                                       f"{dead[0][1]} and no result")
                continue
            if not ok:
                raise RuntimeError(f"run_spmd: rank {rank} of {nprocs} failed:\n{payload}")
            got[rank] = payload
        failed = False
    finally:
        for p in procs:
            if failed and p.is_alive():
                p.terminate()
        for p in procs:
            p.join(_JOIN_S)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [got[r] for r in range(nprocs)]


def _bits_eq(a, b) -> bool:
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape
                and a.tobytes() == b.tobytes())
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_bits_eq(u, v) for u, v in zip(a, b)))
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_bits_eq(a[k], b[k]) for k in a))
    if isinstance(a, float):
        return isinstance(b, float) and np.float64(a).tobytes() == np.float64(b).tobytes()
    return a == b


def same_bits(values) -> bool:
    """True where every rank's result is the same, bit for bit: arrays by
    their bytes, floats by theirs, containers element by element."""
    return all(_bits_eq(values[0], v) for v in values[1:])
