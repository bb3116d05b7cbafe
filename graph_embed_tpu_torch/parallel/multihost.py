"""One block of shards per process, over ``torch.distributed``.

Counterpart of graph_embed_tpu/parallel/multihost.py.  The reference
bootstraps ``jax.distributed`` and builds one mesh over every device of
every process; here each process holds a contiguous block of the mesh's
shards, stacked on its own device as ``make_mesh`` stacks them all, and
the multi-shard designs exchange what crosses a process boundary through
the mesh's ``Comm``:

* the replicated step (``parallel/sharded.py``): the shard-order sum of
  the attraction partials becomes the local sum and an all-reduce (every
  row has one owning shard, so each row's sum adds only zeros), the
  updated vertex blocks an all-gather;
* the halo step (``parallel/halo.py``): the boundary pool and the
  stratified sample rows are all-gathers, the invariant sample rows an
  all-reduce of exclusively owned rows, and the ring's hop between
  processes (``parallel/overlap.py``) a send/recv pair;
* the sharded refinement (``parallel/sharded_ml.py``): no exchange
  during the iterations, one all-gather of the slot space at the end.

Every rank draws the same samples from the same seeded generator, so 2
processes x 4 shards give the 1 x 8 layout bit for bit.

Transport: ``gloo`` serves CPU tensors and a host whose ranks share one
card; gloo takes no send/recv or all-gather of CUDA tensors, so there a
CUDA tensor is staged through host memory, chosen by backend.  ``nccl``
needs one card per rank (it runs no two ranks on one card) and takes the
CUDA tensors as they are.
"""

from __future__ import annotations

import os
import time

import torch
import torch.distributed as dist

from ..utils.device import resolve
from .mesh import EDGE_AXIS, ShardMesh, edge_sharding


class Comm:
    """This process's place in a ``torch.distributed`` group and the
    collectives the multi-shard designs take, with the seconds spent
    staging CUDA tensors through host memory (``stage_seconds``) and in
    the collectives themselves (``collective_seconds``)."""

    def __init__(self, group=None):
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        self.backend = dist.get_backend(group)
        self.stage_seconds = 0.0
        self.collective_seconds = 0.0

    def _peer(self, rank: int) -> int:
        """The global rank of ``rank`` in this group."""
        if self.group is None:
            return rank
        return dist.get_global_rank(self.group, rank)

    def _staged(self, t: torch.Tensor) -> bool:
        return t.is_cuda and self.backend == "gloo"

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the backend takes it: a contiguous host copy of a CUDA
        tensor under gloo (after the current stream's work, which is not
        counted as staging), else ``t`` contiguous."""
        if not self._staged(t):
            return t.contiguous()
        torch.cuda.current_stream(t.device).synchronize()
        t0 = time.perf_counter()
        h = t.cpu()
        self.stage_seconds += time.perf_counter() - t0
        return h

    def _back(self, h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """A received ``h`` on ``like``'s device."""
        if not self._staged(like):
            return h
        t0 = time.perf_counter()
        out = h.to(like.device)
        self.stage_seconds += time.perf_counter() - t0
        return out

    def _timed(self, fn):
        t0 = time.perf_counter()
        fn()
        self.collective_seconds += time.perf_counter() - t0

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``t``, on ``t``'s device."""
        h = self._out(t)
        if h is t:
            h = t.clone()
        self._timed(lambda: dist.all_reduce(h, group=self.group))
        return self._back(h, t)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (one shape on every rank), concatenated on
        the leading axis in rank order, on ``t``'s device."""
        h = self._out(t)
        parts = [torch.empty_like(h) for _ in range(self.world)]
        self._timed(lambda: dist.all_gather(parts, h, group=self.group))
        return self._back(torch.cat(parts), t)

    def shift(self, t: torch.Tensor) -> torch.Tensor:
        """The ring's hop: ``t`` goes to rank + 1, and the previous rank's
        ``t`` (the same shape) comes back, on ``t``'s device."""
        h = self._out(t)
        got = torch.empty_like(h)

        def hop():
            reqs = [dist.isend(h, self._peer((self.rank + 1) % self.world),
                               group=self.group),
                    dist.irecv(got, self._peer((self.rank - 1) % self.world),
                               group=self.group)]
            for r in reqs:
                r.wait()

        self._timed(hop)
        return self._back(got, t)


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, *,
                     backend: str | None = None) -> None:
    """Join the process group (``torch.distributed.init_process_group``).

    The arguments default to the variables ``torchrun`` sets:
    ``MASTER_ADDR``/``MASTER_PORT`` (``coordinator_address`` is
    "host:port", or an init URL such as ``file:///path`` or
    ``tcp://host:port``), ``WORLD_SIZE`` and ``RANK``.  A no-op when the
    group exists already or there is one process.  ``backend``: "gloo"
    (the default; CPU tensors, or ranks sharing one card) or "nccl" (one
    card per rank).  A failed rendezvous raises: a multi-process run must
    not carry on alone."""
    if dist.is_initialized():
        return
    world = int(num_processes if num_processes is not None
                else os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return
    rank = int(process_id if process_id is not None
               else os.environ["RANK"])
    if coordinator_address is None:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ['MASTER_PORT']}")
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(backend or "gloo", init_method=url,
                            world_size=world, rank=rank)


def global_mesh(axis: str = EDGE_AXIS, *, shards_per_process: int = 1,
                device="cuda") -> ShardMesh:
    """A mesh of ``world * shards_per_process`` shards, this process
    holding [rank * k, (rank + 1) * k) on ``device`` (the card by
    default).  Without a process group, or with one process, every shard
    is in this process, as ``make_mesh`` stacks them.  ``axis`` names the
    mesh's one axis, as in the reference."""
    if axis != EDGE_AXIS:
        raise ValueError(f"the mesh has the one axis {EDGE_AXIS!r}")
    comm = None
    if dist.is_initialized() and dist.get_world_size() > 1:
        comm = Comm()
    world = 1 if comm is None else comm.world
    return ShardMesh(world * int(shards_per_process), resolve(device),
                     comm=comm)


def process_local_edge_slice(num_edges_padded: int) -> tuple[int, int]:
    """[start, stop) of the edge axis this process materializes: the
    reference's equal cut, (pid * per, (pid + 1) * per)."""
    nproc, pid = 1, 0
    if dist.is_initialized():
        nproc, pid = dist.get_world_size(), dist.get_rank()
    per = num_edges_padded // nproc
    return pid * per, (pid + 1) * per


def shard_edges_global(arrays, mesh: ShardMesh) -> tuple:
    """This process's shard blocks of each 1-D array (a leading axis that
    splits into ``mesh.ndev`` equal blocks), as one stacked tensor each on
    ``mesh.device``; host numpy or tensors in, only those rows read."""
    layout = edge_sharding(mesh)

    def one(a):
        lo, hi = layout.rows(len(a))
        return torch.as_tensor(a[lo:hi]).to(mesh.device)

    return tuple(one(a) for a in arrays)
