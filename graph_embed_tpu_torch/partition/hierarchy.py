"""Partition drivers: the multilevel hierarchy, single-level, numParts,
and the partitionTest / partitionBase variants.

Counterpart of graph_embed_tpu/partition/hierarchy.py (the
``partition::partition`` overloads, src/partitioner.cpp:970-1266,
:1272-1544, :1550-1893, and :116-966).  Two backends give the same
hierarchy: ``native``, the host C++ coarsener (native/csrc/coarsen.cpp),
which also emits the Galerkin chain A_{l+1} = P^T A P; and ``device``, the
round loop below over coarsen.py on the graph's device.  ``auto`` takes
native when the graph has a host COO and the library builds, device
otherwise (a graph that lives only on the card).

The device round loop reads the merge count and the live edge count once
per round, as the reference does.  A level snapshot is taken whenever the
live count crosses the coarsening factor (:1797-1815): labels path-
compressed, representatives densely ranked, the level's assignment
recorded; a final snapshot is always appended (:1840-1853).
"""

from __future__ import annotations

import dataclasses

import torch

from ..graph.csr import Graph, from_canonical_coo
from ..utils.params import PartitionParams
from .coarsen import (CoarsenState, absorb_round, coarsen_round, dense_ranks,
                      init_state, merge_leaves_round, resolve_labels)
from .interpolation import Partition, compose


@dataclasses.dataclass
class HierarchyResult:
    """levels[l] maps level-l vertices to level-(l+1) aggregates;
    ``modularity`` is the final running Q; ``coarse_graphs`` is the
    Galerkin tail [A_1 ... A_k] (native backend with ``emit_graphs``, else
    None)."""

    levels: list[Partition]
    modularity: float
    level_sizes: list[int]
    coarse_graphs: list[Graph] | None = None


def _snapshot(st: CoarsenState, prev_reps: torch.Tensor, m: int):
    """(state with resolved labels, the previous level's assignment onto
    the m live representatives, the new representatives)."""
    label = resolve_labels(st.label)
    assign = dense_ranks(st.live)[label[prev_reps]]
    reps = torch.nonzero(st.live).flatten()
    return dataclasses.replace(st, label=label), Partition(assign, m), reps


def _reset_size(st: CoarsenState) -> CoarsenState:
    return dataclasses.replace(st, size=torch.ones_like(st.size))


def _run_rounds(st: CoarsenState, T, n0: int, params: PartitionParams, *,
                coarsening_factor: float | None = None,
                num_parts: int | None = None):
    """The merge loop (hierarchy.py:77-186): a snapshot per crossing of
    ``coarsening_factor`` when given, else one at the end; stops at a
    stall or at ``num_parts``."""
    levels: list[Partition] = []
    level_sizes = [n0]
    prev_reps = torch.arange(n0, device=st.alpha.device)
    if params.merge_leaves:
        while True:
            st, num = merge_leaves_round(st, T, params.positive_merging)
            if num == 0:
                break
    m = int(st.live.sum())
    n_level = n0
    rnd = 0
    positive = params.positive_merging
    hierarchy = coarsening_factor is not None
    while True:
        st, merged, _ = coarsen_round(
            st, T, rnd, params.max_agg_size,
            matching_iterations=params.matching_iterations,
            positive_merging=positive, tie_break=params.tie_break)
        rnd += 1
        m_prev = m
        m = m - merged
        if (hierarchy and params.absorb_below > 0
                and merged < params.absorb_below * m_prev and m > 1
                and (num_parts is None or m > num_parts)):
            # mutual-rate collapse (hub serialization): star-absorb round
            st, merged2, _ = absorb_round(
                st, T, rnd * params.matching_iterations, params.max_agg_size,
                positive_merging=positive, tie_break=params.tie_break)
            rnd += 1
            m = m - merged2
        if hierarchy and m / n_level <= coarsening_factor:
            st, part, prev_reps = _snapshot(st, prev_reps, m)
            levels.append(part)
            level_sizes.append(m)
            n_level = m
            if params.max_agg_size > 0 and params.cap_unit != "original":
                st = _reset_size(st)
        if num_parts is not None and m <= num_parts:
            break
        if m_prev == 0 or m / max(m_prev, 1) >= params.stall_stop_threshold:
            # a stall under an active size cap is a level boundary when the
            # level made real progress (the cap, not the gains, ran out)
            if (params.max_agg_size > 0 and hierarchy
                    and m <= 0.8 * n_level and m > 1):
                st, part, prev_reps = _snapshot(st, prev_reps, m)
                levels.append(part)
                level_sizes.append(m)
                n_level = m
                if params.cap_unit != "original":
                    st = _reset_size(st)
                continue
            # positive merging exhausted while the level is still large:
            # relax DeltaQ > 0 and keep building (force_coarsen_to)
            if (hierarchy and positive and params.force_coarsen_to > 0
                    and m > params.force_coarsen_to and m > 1):
                positive = False
                continue
            break
        if m <= 1:
            break
    if not levels or m < level_sizes[-1]:
        st, part, prev_reps = _snapshot(st, prev_reps, m)
        levels.append(part)
        level_sizes.append(m)
    return st, levels, level_sizes


def _native_available(g: Graph) -> bool:
    """The native coarsener is taken when the graph carries a host COO (no
    pull from the device) and the library builds."""
    if g.host_coo is None:
        return False
    try:
        from ..native import coarsen_lib

        coarsen_lib._lib()
        return True
    except Exception:
        return False


def _pick_backend(backend: str, g: Graph) -> str:
    if backend == "auto":
        return "native" if _native_available(g) else "device"
    if backend not in ("native", "device"):
        raise ValueError(f"unknown backend {backend!r}")
    return backend


def _run_native(g: Graph, params: PartitionParams, *,
                coarsening_factor: float = 0.0, num_parts: int = 0,
                emit_graphs: bool = False):
    """The native coarsener on ``g``'s host COO (hierarchy.py:202-239):
    (levels on ``g``'s device, level_sizes, Q, Galerkin tail or None)."""
    from ..native import coarsen_lib

    s, r, w = g.to_coo_numpy()
    assignments, level_sizes, Q, coo = coarsen_lib.coarsen_run(
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
    levels = [Partition.from_numpy(a, int(level_sizes[i + 1]),
                                   device=g.device)
              for i, a in enumerate(assignments)]
    graphs = None
    if emit_graphs:
        graphs = [from_canonical_coo(cs, cr, cw, int(level_sizes[i + 1]),
                                     dtype=g.dtype, device=g.device)
                  for i, (cs, cr, cw) in enumerate(coo)]
    return levels, [int(x) for x in level_sizes], Q, graphs


def _print(res: HierarchyResult, n: int) -> None:
    print(f"modularity: {res.modularity}")
    print(f"level 0: {n} aggregates")
    for i, p in enumerate(res.levels):
        print(f"level {i + 1}: {p.num_aggs} aggregates")


def partition_hierarchy(g: Graph, coarsening_factor: float,
                        params: PartitionParams | None = None,
                        backend: str = "auto",
                        emit_graphs: bool = False) -> HierarchyResult:
    """One level snapshot per crossing of ``coarsening_factor`` plus a
    final one (partitioner.cpp:1550-1893).  ``backend``: 'native',
    'device' or 'auto' (see the module doc).  Partitions and coarse graphs
    land on ``g``'s device; ``emit_graphs`` has the native backend emit the
    Galerkin tail (the device backend emits none)."""
    params = params or PartitionParams()
    if _pick_backend(backend, g) == "native":
        levels, level_sizes, Q, graphs = _run_native(
            g, params, coarsening_factor=coarsening_factor,
            emit_graphs=emit_graphs)
        res = HierarchyResult(levels=levels, modularity=Q,
                              level_sizes=level_sizes, coarse_graphs=graphs)
    else:
        st, T = init_state(g, weight_jitter=params.weight_jitter)
        st, levels, level_sizes = _run_rounds(
            st, T, g.n, params, coarsening_factor=coarsening_factor)
        res = HierarchyResult(levels=levels, modularity=float(st.Q),
                              level_sizes=level_sizes)
    if params.printing:
        _print(res, g.n)
    return res


def partition_single(g: Graph, params: PartitionParams | None = None,
                     backend: str = "auto") -> Partition:
    """Single-level production coarsener (partitioner.cpp:970-1266): the
    merge loop run to stall, one vertex -> aggregate Partition on ``g``'s
    device."""
    params = params or PartitionParams()
    if _pick_backend(backend, g) == "native":
        levels, _, Q, _ = _run_native(g, params)
        part = levels[0]
    else:
        st, T = init_state(g, weight_jitter=params.weight_jitter)
        st, levels, _ = _run_rounds(st, T, g.n, params)
        part, Q = compose(levels), float(st.Q)
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
    if _pick_backend(backend, g) == "native":
        levels, _, _, _ = _run_native(g, params, num_parts=num_parts)
        return levels[0]
    st, T = init_state(g, weight_jitter=params.weight_jitter)
    _, levels, _ = _run_rounds(st, T, g.n, params, num_parts=num_parts)
    return compose(levels)


def partition_test(g: Graph, stall_stop_threshold: float = 1.0) -> Partition:
    """partitionTest (partitioner.cpp:116-433): the mutual-best rule,
    positive merges only, one matching pass per round."""
    return partition_single(g, PartitionParams(
        positive_merging=True, stall_stop_threshold=stall_stop_threshold,
        matching_iterations=1))


def _partition_greedy(g: Graph, stall_stop_threshold: float, variant: str,
                      backend: str) -> Partition:
    from ..native import greedy_lib
    from .greedy import greedy_partition_py

    if backend == "python" or (backend == "auto"
                               and not greedy_lib.available()):
        part, _ = greedy_partition_py(g, stall_stop_threshold,
                                      variant=variant)
        return part
    s, r, w = g.to_coo_numpy()
    assign, m, _ = greedy_lib.greedy_run(
        g.n, s, r, w, stall_stop_threshold=stall_stop_threshold,
        variant=variant)
    return Partition.from_numpy(assign, m, device=g.device)


def partition_base(g: Graph, stall_stop_threshold: float = 1.0, *,
                   backend: str = "auto") -> Partition:
    """partitionBase (partitioner.cpp:436-694): the one-sided greedy rule
    the reference's harness runs (run-tests.cpp:199), sequential, so on
    the host: native C++ by default, the pure-Python version (bit-identical
    float32 math) with ``backend="python"`` or when the library does not
    build."""
    return _partition_greedy(g, stall_stop_threshold, "base", backend)


def partition_base2(g: Graph, stall_stop_threshold: float = 1.0, *,
                    backend: str = "auto") -> Partition:
    """partitionBase2 (partitioner.cpp:696-966): the same greedy rule
    without the i < j commit gate (:836-858); neighbours are scanned in
    sorted order, as in the JAX package."""
    return _partition_greedy(g, stall_stop_threshold, "base2", backend)
