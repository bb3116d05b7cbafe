"""Deterministic far-field repulsion over partition centroids: the flat
step's ``repulsion="centroids"``.

Counterpart of graph_embed_tpu/forceatlas/farfield.py.  The reference
computes repulsion all-pairs (forceatlas.hpp:151) or within aggregates
(:394); this mode makes the multilevel structure an explicit Barnes-Hut:

  F_i ~= exact within group(i)                         (member tables)
       + sum_{g != group(i)} M_g (x_i - c_g) / d^3     (monopole far field)

with mass-weighted centroids c_g and masses M_g = sum (deg_j + 1).  The
far field is an [n, m] gram-form interaction in full-float32 matmuls,
row-blocked to bound memory; the near field is the portable refinement's
``aggregate_repulsion`` (kernel B on the card, over the slot space that
``Groups.build`` makes once); the per-group sums run through
``ops.segment``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import bucket_repulsion as BR
from ..ops import edge_spmm as ES
from ..ops import segment
from ..partition.interpolation import Partition
from .multilevel import (PAIR_BUDGET, aggregate_repulsion,
                         check_full_float32, repulsion_members)


@dataclasses.dataclass(frozen=True)
class Groups:
    """A grouping on one device with its tables: the assignment, what the
    near field walks (``repulsion_members``: kernel B's slot space on a
    card, the member tables elsewhere), and the members-by-group segment
    CSR."""

    part: Partition
    members: tuple | BR.SlotSpace
    csr: ES.EdgeCSR

    @classmethod
    def build(cls, part: Partition, device) -> "Groups":
        part = part.to(device)
        members = repulsion_members(part, device)
        return cls(part=part, members=members, csr=part.segment_csr())


def group_moments(coords, deg_p1, groups: Groups):
    """(masses [m], centroids [m, d]): M_g = sum deg + 1 over the group,
    c_g the mass-weighted mean."""
    mass = segment.segment_sum(deg_p1, groups.csr)
    wsum = segment.segment_sum(coords * deg_p1[:, None], groups.csr)
    return mass, wsum / torch.clamp(mass, min=1e-30)[:, None]


def centroid_repulsion(coords, deg_p1, groups: Groups, repel: float,
                       eps: float) -> torch.Tensor:
    """[n, d] approximate repulsion: the exact near field within each
    vertex's group plus the monopole far field of every other group, in
    row blocks of at most ``PAIR_BUDGET`` vertex-group pairs."""
    check_full_float32()
    v2g = groups.part.vertex_to_agg
    mass, cent = group_moments(coords, deg_p1, groups)
    n, m = coords.shape[0], cent.shape[0]
    sq_c = torch.sum(cent * cent, dim=1)
    block = max(1, PAIR_BUDGET // max(m, 1))
    far = []
    for row0 in range(0, n, block):
        x = coords[row0: row0 + block]
        d2 = (torch.sum(x * x, dim=1)[:, None] + sq_c[None, :]
              - 2.0 * (x @ cent.T))
        dist = torch.clamp(torch.sqrt(torch.clamp(d2, min=0.0)), min=eps)
        W = mass[None, :] / (dist * dist * dist)
        far.append(x * torch.sum(W, dim=1, keepdim=True) - W @ cent)
    f_far = torch.cat(far, dim=0)
    # the own group's monopole comes out; its exact term is the near field
    diff_own = coords - cent[v2g]
    d_own = torch.clamp(torch.sqrt(torch.sum(diff_own * diff_own, dim=1)),
                        min=eps)
    f_far = f_far - diff_own * (mass[v2g] / (d_own * d_own * d_own))[:, None]
    near = aggregate_repulsion(coords, groups.members, deg_p1, repel, eps)
    return (repel * deg_p1)[:, None] * f_far + near
