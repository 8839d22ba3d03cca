"""The mesh of a distributed run and its three collectives.

Counterpart of `make_mesh` (lilac_tpu/parallel/dist.py) and of the
collectives its shard_map programs call (`lax.all_gather`, `lax.psum`,
`lax.ppermute`). PyTorch has no single program over a mesh: the port runs
one process per rank on a torch.distributed group (parallel/launch.py
starts them), and each rank calls `make_mesh` to learn its place.

Two transports, chosen by the caller and never switched behind its back:

* "device": NCCL, one rank per card. The tensors stay on the card.
* "host":   Gloo. Each collective copies its tensor to the host, runs
  there, and copies the result back to the rank's device. Gloo's
  all_gather and send / recv take CPU tensors only, and NCCL refuses two
  ranks on one card, so this is how several ranks share one GPU. The
  arithmetic stays on the rank's device either way.

The collectives use only calls that torch 2.11 and 2.13 both have: the list
form of `dist.all_gather` and `dist.batch_isend_irecv` of `P2POp`s.
"""

from __future__ import annotations

import dataclasses
import time

import torch
import torch.distributed as dist

TRANSPORTS = {"nccl": "device", "gloo": "host"}


def transport_of(backend: str, size: int) -> str:
    """The transport of `size` ranks on `backend`: "device" for NCCL (one
    rank per card, raises where the machine has fewer cards than ranks),
    "host" for Gloo."""
    if backend not in TRANSPORTS:
        raise ValueError(f"backend {backend!r}: one of {sorted(TRANSPORTS)}")
    if backend == "nccl":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if size > cards:
            raise ValueError(
                f"NCCL takes one rank per card: {size} rank(s) on {cards} CUDA "
                "device(s). Ranks that share a card take backend='gloo' "
                "(transport 'host').")
    return TRANSPORTS[backend]


@dataclasses.dataclass
class Mesh:
    """One rank's view of a 1-D mesh of `size` ranks.

    group is the torch.distributed group (None for a world of one outside
    any group: every collective is then the identity). `calls`, `seconds`
    and `bytes` count the collectives this rank ran, their host-clock time
    and the bytes it handed them: what a matvec spends in the transport."""

    axis: str
    rank: int
    size: int
    device: torch.device
    group: object
    transport: str
    calls: int = 0
    seconds: float = 0.0
    bytes: int = 0

    def _out(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        return x.cpu() if self.transport == "host" else x

    def _back(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.device) if self.transport == "host" else x

    def _gather(self, x: torch.Tensor) -> list:
        if self.group is None:
            return [x]
        t0 = time.perf_counter()
        src = self._out(x)
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        parts = [self._back(p) for p in parts]
        self.calls += 1
        self.bytes += src.numel() * src.element_size()
        self.seconds += time.perf_counter() - t0
        return parts

    def all_gather_tiled(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's x concatenated in rank order along dim 0:
        `lax.all_gather(x, axis, tiled=True)`."""
        parts = self._gather(x)
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def all_gather_stack(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's x stacked in rank order: [size, *x.shape]."""
        return torch.stack(self._gather(x))

    def ring_shift(self, buf: torch.Tensor, k: int) -> torch.Tensor:
        """`lax.ppermute` with the pairs i -> (i + k) % size: this rank sends
        buf to rank + k and returns what rank - k sent. Every rank's buf has
        the same shape."""
        k %= self.size
        if self.group is None or k == 0:
            return buf
        t0 = time.perf_counter()
        src = self._out(buf)
        out = torch.empty_like(src)
        ops = [dist.P2POp(dist.isend, src, (self.rank + k) % self.size, self.group),
               dist.P2POp(dist.irecv, out, (self.rank - k) % self.size, self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        self.calls += 1
        self.bytes += src.numel() * src.element_size()
        self.seconds += time.perf_counter() - t0
        return self._back(out)

    def reset_stats(self) -> None:
        self.calls, self.seconds, self.bytes = 0, 0.0, 0


def _rank_device(device, transport: str, rank: int) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: device 'cuda' but no CUDA device is visible "
                               "(pass device='cpu' for a CPU run)")
        index = rank if transport == "device" else rank % torch.cuda.device_count()
        dev = torch.device("cuda", index)
    if transport == "device" and dev.type != "cuda":
        raise ValueError("NCCL (transport 'device') needs the ranks on CUDA devices")
    return dev


def make_mesh(n_devices: int | None = None, axis: str = "x", *, backend: str | None = None,
              device=None) -> Mesh:
    """This rank's mesh, called inside a rank of a torch.distributed group.

    n_devices: the number of ranks (the group's size; None takes it).
    backend:   "nccl" or "gloo"; None takes the group's (Gloo outside one).
    device:    where this rank's tensors live; None is "cuda" (the card of
               this rank under NCCL, card rank % count under Gloo), "cpu"
               for a CPU run.
    Outside any group it is a world of one. NCCL with more ranks than the
    machine has cards raises, naming both numbers."""
    grouped = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if grouped else 1
    size = world if n_devices is None else int(n_devices)
    if backend is None:
        backend = dist.get_backend() if grouped else "gloo"
    transport = transport_of(backend, size)
    if size != world:
        raise ValueError(
            f"make_mesh({n_devices}): the process group holds {world} rank(s); "
            "start the ranks with parallel.launch.run_spmd")
    if grouped and dist.get_backend() != backend:
        raise ValueError(f"make_mesh: backend {backend!r}, the group runs "
                         f"{dist.get_backend()!r}")
    rank = dist.get_rank() if grouped else 0
    return Mesh(axis=axis, rank=rank, size=size,
                device=_rank_device("cuda" if device is None else device, transport, rank),
                group=dist.group.WORLD if grouped else None, transport=transport)
