"""The shard mesh of the port's multi-shard designs.

Counterpart of graph_embed_tpu/parallel/mesh.py.  The JAX package shards
over a 1D device mesh and stacks every per-device plan array on a leading
axis.  Here all ``ndev`` shards live on ONE device, stacked on that same
leading axis (a shard's rows are one contiguous block of every stacked
tensor), and the collectives become fixed-order operations over the shard
axis.  That takes the place of the JAX package's virtual CPU devices
(mesh.py:18-40); there is no fallback to the CPU when a card is asked for
and missing.  One shard per card over ``torch.distributed`` is later work
(ROADMAP queue 1, item 6).

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
    """``ndev`` shards, all on ``device``."""

    ndev: int
    device: torch.device

    def __post_init__(self):
        if self.ndev < 1:
            raise ValueError(f"a mesh needs at least one shard, got "
                             f"{self.ndev}")


EDGE_AXIS = "x"


@dataclasses.dataclass(frozen=True)
class StackedLayout:
    """How a tensor lies over ``mesh``'s shards on its one device: split
    into ``mesh.ndev`` contiguous blocks of its leading axis (``split``),
    or replicated, one copy read by every shard."""

    mesh: ShardMesh
    split: bool

    def blocks(self, length: int) -> list[tuple[int, int]]:
        """Each shard's [lo, hi) rows of a leading axis of ``length``."""
        if not self.split:
            return [(0, length)] * self.mesh.ndev
        if length % self.mesh.ndev:
            raise ValueError(f"a leading axis of {length} does not split "
                             f"into {self.mesh.ndev} equal blocks")
        b = length // self.mesh.ndev
        return [(d * b, (d + 1) * b) for d in range(self.mesh.ndev)]

    def put(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` on the mesh's device, its leading axis checked to split."""
        self.blocks(int(t.shape[0]))
        return t.to(self.mesh.device)


def edge_sharding(mesh: ShardMesh) -> StackedLayout:
    """Leading axis split into contiguous blocks, one per shard."""
    return StackedLayout(mesh, split=True)


def replicated(mesh: ShardMesh) -> StackedLayout:
    """One copy that every shard reads."""
    return StackedLayout(mesh, split=False)


def make_mesh(n: int, *, device="cuda") -> ShardMesh:
    """A mesh of ``n`` shards on ``device`` (the card by default)."""
    return ShardMesh(int(n), resolve(device))


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
