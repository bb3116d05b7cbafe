"""Per-level pieces of forceAtlasMultilevel (include/forceatlas.hpp:
314-574) that the slot-space refinement needs.  Counterpart of
graph_embed_tpu/forceatlas/multilevel.py:93-135; the portable
``force_atlas_multilevel`` is not ported yet (ROADMAP queue 1,
item 3).

Both per-vertex sums run over the graph's stored entries, which are sorted
by sender, through ``ops.segment``: kernel A's unit mode on the card (each
vertex's entries are added in a fixed order, so the result is bitwise
repeatable), its plain version on the CPU.
"""

from __future__ import annotations

import torch

from ..graph.csr import Graph
from ..ops import edge_spmm as ES
from ..ops import segment
from ..partition.interpolation import Partition


def sender_csr(g: Graph) -> ES.EdgeCSR:
    """The segment CSR of ``g``'s stored entries by sender (entry e is
    column e; built on the device from the row pointers)."""
    return segment.sorted_csr(g.indptr, g.num_edges)


def local_degrees(g: Graph, part: Partition, use_weights: bool):
    """deg_i = same-aggregate incident edge weight, self-loops included
    (forceatlas.hpp:362-383)."""
    v2a = part.vertex_to_agg
    same = v2a[g.senders] == v2a[g.receivers]
    val = g.weights if use_weights else torch.ones_like(g.weights)
    val = torch.where(same, val, torch.zeros_like(val))
    return segment.segment_sum(val, sender_csr(g))


def external_pull(g: Graph, part: Partition, coords_A: torch.Tensor, *,
                  pull: float, eps: float,
                  csr: ES.EdgeCSR | None = None) -> torch.Tensor:
    """Per-vertex cut-edge pull (forceatlas.hpp:451-466):
    P_i = sum over stored entries (i, j) with agg(j) != agg(i) of
    pull * (c_{agg j} - c_{agg i}) / max(|c_{agg j} - c_{agg i}|, eps).
    Computed once per level, per entry and then summed per sender (not as
    ``A c - c * rowsum``, which would add a cancellation the reference
    does not have); every per-entry temporary is a flat [E] vector."""
    v2a = part.vertex_to_agg
    a_s = v2a[g.senders]
    a_r = v2a[g.receivers]
    d = coords_A.shape[1]
    diff = [coords_A[:, k][a_r] - coords_A[:, k][a_s] for k in range(d)]
    d2 = diff[0] * diff[0]
    for k in range(1, d):
        d2 = d2 + diff[k] * diff[k]
    dist = torch.clamp(torch.sqrt(d2), min=eps)
    scale = torch.where(a_s != a_r, pull / dist, torch.zeros_like(dist))
    per_entry = torch.stack([diff[k] * scale for k in range(d)], dim=1)
    return segment.segment_sum(per_entry, csr or sender_csr(g))
