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


def make_mesh(n: int, *, device="cuda") -> ShardMesh:
    """A mesh of ``n`` shards on ``device`` (the card by default)."""
    return ShardMesh(int(n), resolve(device))


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
