"""Partition drivers on the native C++ coarsener: the multilevel
hierarchy, single-level and numParts.

Counterpart of graph_embed_tpu/partition/hierarchy.py:248-329 with
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


def _run_native(g: Graph, params: PartitionParams, backend: str, *,
                coarsening_factor: float = 0.0, num_parts: int = 0,
                emit_graphs: bool = False):
    """The native coarsener on ``g``'s host COO (hierarchy.py:202-245):
    (assignments, level_sizes, Q, Galerkin COOs or None)."""
    if backend == "device":
        raise NotImplementedError(
            "the device coarsener is not ported yet (ROADMAP queue 1, "
            "item 7: device coarsener and device Galerkin)")
    if backend not in ("native", "auto"):
        raise ValueError(f"unknown backend {backend!r}")
    if g.host_coo is None:
        raise ValueError("the native coarsener needs the graph's host COO")
    from ..native import coarsen_lib

    s, r, w = g.to_coo_numpy()
    return coarsen_lib.coarsen_run(
        g.n, s, r, w,
        coarsening_factor=coarsening_factor, num_parts=num_parts,
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


def partition_hierarchy(g: Graph, coarsening_factor: float,
                        params: PartitionParams | None = None,
                        backend: str = "native",
                        emit_graphs: bool = False) -> HierarchyResult:
    """One level snapshot per crossing of ``coarsening_factor`` plus a
    final one (partitioner.cpp:1550-1893).  Partitions and coarse graphs
    land on ``g``'s device."""
    params = params or PartitionParams()
    assignments, level_sizes, Q, coo = _run_native(
        g, params, backend, coarsening_factor=coarsening_factor,
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


def partition_single(g: Graph, params: PartitionParams | None = None,
                     backend: str = "auto") -> Partition:
    """Single-level production coarsener (partitioner.cpp:970-1266): the
    merge loop run to stall, one vertex -> aggregate Partition on ``g``'s
    device."""
    params = params or PartitionParams()
    assignments, level_sizes, Q, _ = _run_native(g, params, backend)
    part = Partition.from_numpy(assignments[0], int(level_sizes[1]),
                                device=g.device)
    if params.printing:
        print(f"modularity: {Q}")
        print(f"aggregates: {part.num_aggs}")
    return part


def partition_num_parts(g: Graph, num_parts: int,
                        params: PartitionParams | None = None,
                        backend: str = "auto") -> Partition:
    """numParts variant (partitioner.cpp:1272-1544): the merge loop also
    halts once the live count reaches ``num_parts``."""
    params = params or PartitionParams()
    assignments, level_sizes, _, _ = _run_native(g, params, backend,
                                                 num_parts=num_parts)
    return Partition.from_numpy(assignments[0], int(level_sizes[1]),
                                device=g.device)
