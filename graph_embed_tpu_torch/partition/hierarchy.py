"""The multilevel hierarchy partitioner on the native C++ coarsener.

Counterpart of graph_embed_tpu/partition/hierarchy.py:248-285 with
``backend="native"`` (the backend ``auto`` picks whenever the graph has a
host COO, hierarchy.py:189-199).  The coarsener also emits the Galerkin
chain A_{l+1} = P^T A P (hierarchy.py:202-245), so the embed pipeline needs
no separate coarse-graph build.
"""

from __future__ import annotations

import dataclasses

from ..graph.csr import Graph, from_canonical_coo
from ..utils.params import PartitionParams
from .interpolation import Partition


@dataclasses.dataclass
class HierarchyResult:
    """levels[l] maps level-l vertices to level-(l+1) aggregates;
    ``coarse_graphs`` is the Galerkin tail [A_1 ... A_k] (None unless
    ``emit_graphs``)."""

    levels: list[Partition]
    modularity: float
    level_sizes: list[int]
    coarse_graphs: list[Graph] | None = None


def partition_hierarchy(g: Graph, coarsening_factor: float,
                        params: PartitionParams | None = None,
                        backend: str = "native",
                        emit_graphs: bool = False) -> HierarchyResult:
    """One level snapshot per crossing of ``coarsening_factor`` plus a
    final one (partitioner.cpp:1550-1893).  Partitions and coarse graphs
    land on ``g``'s device."""
    if backend == "device":
        raise NotImplementedError(
            "the device coarsener is not ported yet (ROADMAP queue 1, "
            "item 7: device coarsener and device Galerkin)")
    if backend not in ("native", "auto"):
        raise ValueError(f"unknown backend {backend!r}")
    if g.host_coo is None:
        raise ValueError("the native coarsener needs the graph's host COO")
    from ..native import coarsen_lib

    params = params or PartitionParams()
    s, r, w = g.to_coo_numpy()
    assignments, level_sizes, Q, coo = coarsen_lib.coarsen_run(
        g.n, s, r, w,
        coarsening_factor=coarsening_factor,
        matching_iterations=params.matching_iterations,
        positive_merging=params.positive_merging,
        stall_stop_threshold=params.stall_stop_threshold,
        merge_leaves=params.merge_leaves, tie_break=params.tie_break,
        weight_jitter=params.weight_jitter,
        max_agg_size=(-params.max_agg_size if params.cap_unit == "original"
                      else params.max_agg_size),
        absorb_below=params.absorb_below if coarsening_factor > 0 else 0.0,
        force_coarsen_to=(params.force_coarsen_to
                          if coarsening_factor > 0 else 0),
        emit_graphs=emit_graphs)
    levels = [Partition.from_numpy(a, int(level_sizes[i + 1]),
                                   device=g.device)
              for i, a in enumerate(assignments)]
    graphs = None
    if emit_graphs:
        graphs = [from_canonical_coo(cs, cr, cw, int(level_sizes[i + 1]),
                                     dtype=g.dtype, device=g.device)
                  for i, (cs, cr, cw) in enumerate(coo)]
    res = HierarchyResult(levels=levels, modularity=Q,
                          level_sizes=[int(x) for x in level_sizes],
                          coarse_graphs=graphs)
    if params.printing:
        print(f"modularity: {res.modularity}")
        print(f"level 0: {g.n} aggregates")
        for i, p in enumerate(levels):
            print(f"level {i + 1}: {p.num_aggs} aggregates")
    return res

