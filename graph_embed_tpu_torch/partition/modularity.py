"""Modularity of a partition, Q = sum_A (d_A/T - alpha_A^2)
(``partition::modularity``, src/partitioner.cpp:69-114).

Counterpart of graph_embed_tpu/partition/modularity.py: d_A is the
intra-aggregate stored weight, out_A the outgoing inter-aggregate weight,
alpha_A = (d_A + out_A)/T and T the total stored weight.  The two per-
aggregate sums are one row-owned segment sum on the graph's device
(``ops.segment.grouped``: entries grouped by their sender's aggregate with a
stable sort, summed by kernel A on the card), so the result does not
depend on atomics.

The reference truncates each weight to ``int`` (``int a_ij = D[k]``,
partitioner.cpp:90); ``int_truncate=True`` reproduces that quirk, the
default is the exact math.
"""

from __future__ import annotations

import torch

from ..graph.csr import Graph
from ..ops import segment
from .interpolation import Partition


def modularity(g: Graph, p: Partition, *, int_truncate: bool = False
               ) -> torch.Tensor:
    """Q of ``g`` under ``p`` as a 0-d tensor on ``g``'s device."""
    w = torch.trunc(g.weights) if int_truncate else g.weights
    v2a = p.vertex_to_agg.to(g.device)
    a = v2a[g.senders]
    intra = a == v2a[g.receivers]
    T = w.sum()
    zero = torch.zeros_like(w)
    parts = torch.stack([torch.where(intra, w, zero),
                         torch.where(intra, zero, w)], dim=1)
    order, csr = segment.grouped(a, p.num_aggs)
    sums = segment.segment_sum(parts[order], csr)
    d = sums[:, 0]
    alpha = (d + sums[:, 1]) / T
    return torch.sum(d / T - alpha * alpha)
