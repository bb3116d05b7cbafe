"""Per-level pieces of forceAtlasMultilevel (include/forceatlas.hpp:
314-574) that the slot-space refinement needs.  Counterpart of
graph_embed_tpu/forceatlas/multilevel.py:93-135; the portable
``force_atlas_multilevel`` is not ported yet (ROADMAP queue 1,
item 3)."""

from __future__ import annotations

import torch

from ..graph.csr import Graph
from ..partition.interpolation import Partition


def local_degrees(g: Graph, part: Partition, use_weights: bool):
    """deg_i = same-aggregate incident edge weight, self-loops included
    (forceatlas.hpp:362-383)."""
    v2a = part.vertex_to_agg
    same = v2a[g.senders] == v2a[g.receivers]
    val = g.weights if use_weights else torch.ones_like(g.weights)
    val = torch.where(same, val, torch.zeros_like(val))
    out = torch.zeros(g.n, dtype=g.dtype, device=g.device)
    return out.index_add_(0, g.senders, val)


def external_pull(g: Graph, part: Partition, coords_A: torch.Tensor, *,
                  pull: float, eps: float) -> torch.Tensor:
    """Per-vertex cut-edge pull (forceatlas.hpp:451-466):
    P_i = sum over stored entries (i, j) with agg(j) != agg(i) of
    pull * (c_{agg j} - c_{agg i}) / max(|c_{agg j} - c_{agg i}|, eps).
    Computed once per level; unrolled over the coordinate axis so every
    temporary is a flat [E] vector."""
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
    cols = [torch.zeros(g.n, dtype=coords_A.dtype, device=coords_A.device)
            .index_add_(0, g.senders, diff[k] * scale) for k in range(d)]
    return torch.stack(cols, dim=1)
