"""The shard mesh of the port's multi-shard designs.

Counterpart of graph_embed_tpu/parallel/mesh.py.  The JAX package shards
over a 1D device mesh and stacks every per-device plan array on a leading
axis.  Here a process holds its shards on ONE device, stacked on that same
leading axis (a shard's rows are one contiguous block of every stacked
tensor), and the collectives between them are fixed-order operations over
the shard axis.  That takes the place of the JAX package's virtual CPU
devices (mesh.py:18-40); there is no fallback to the CPU when a card is
asked for and missing.

A mesh from ``parallel.multihost.global_mesh`` spans processes: process p
of P holds the contiguous shards [p k, (p + 1) k), k = ndev / P, and the
collectives between processes go through its ``comm``
(``multihost.Comm``, over ``torch.distributed``).  ``make_mesh`` gives a
mesh of one process, every shard stacked.

The JAX package's two shardings (mesh.py:42-47) become two stacked
layouts: ``edge_sharding`` splits a tensor's leading axis into ``ndev``
contiguous blocks, shard d owning block d (``P(EDGE_AXIS)``), and
``replicated`` is one copy that every shard reads (``P()``).
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils.device import resolve


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """``ndev`` shards on ``device``: all of them in this process, or with
    ``comm`` (``multihost.Comm``) this process's block of them."""

    ndev: int
    device: torch.device
    comm: object = dataclasses.field(default=None, compare=False)

    def __post_init__(self):
        if self.ndev < 1:
            raise ValueError(f"a mesh needs at least one shard, got "
                             f"{self.ndev}")
        if self.ndev % self.process_count:
            raise ValueError(f"{self.ndev} shards do not split over "
                             f"{self.process_count} processes")

    @property
    def process_index(self) -> int:
        return 0 if self.comm is None else self.comm.rank

    @property
    def process_count(self) -> int:
        return 1 if self.comm is None else self.comm.world

    @property
    def group(self):
        """The ``torch.distributed`` process group (None: one process, or
        the default group)."""
        return None if self.comm is None else self.comm.group

    @property
    def local_shards(self) -> range:
        """The shards this process holds."""
        k = self.ndev // self.process_count
        return range(self.process_index * k, (self.process_index + 1) * k)


EDGE_AXIS = "x"


@dataclasses.dataclass(frozen=True)
class StackedLayout:
    """How a tensor lies over ``mesh``'s shards: split into ``mesh.ndev``
    contiguous blocks of its leading axis (``split``), of which this
    process holds its own, or replicated, one copy read by every shard."""

    mesh: ShardMesh
    split: bool

    def blocks(self, length: int) -> list[tuple[int, int]]:
        """This process's shards' [lo, hi) rows of a leading axis of
        ``length``."""
        shards = self.mesh.local_shards
        if not self.split:
            return [(0, length)] * len(shards)
        if length % self.mesh.ndev:
            raise ValueError(f"a leading axis of {length} does not split "
                             f"into {self.mesh.ndev} equal blocks")
        b = length // self.mesh.ndev
        return [(d * b, (d + 1) * b) for d in shards]

    def rows(self, length: int) -> tuple[int, int]:
        """The [lo, hi) rows this process holds (every row, replicated)."""
        blocks = self.blocks(length)
        return blocks[0][0], blocks[-1][1]

    def put(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` on the mesh's device: this process's rows of a split
        layout (every row in one process), the whole tensor replicated."""
        lo, hi = self.rows(int(t.shape[0]))
        return t[lo:hi].to(self.mesh.device)


def edge_sharding(mesh: ShardMesh) -> StackedLayout:
    """Leading axis split into contiguous blocks, one per shard."""
    return StackedLayout(mesh, split=True)


def replicated(mesh: ShardMesh) -> StackedLayout:
    """One copy that every shard reads."""
    return StackedLayout(mesh, split=False)


def make_mesh(n: int, *, device="cuda") -> ShardMesh:
    """A mesh of ``n`` shards, all in this process, on ``device`` (the
    card by default)."""
    return ShardMesh(int(n), resolve(device))


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
