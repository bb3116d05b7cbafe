"""Multilevel embed driver: coarse-to-fine recursion over the hierarchy
(``embed`` / ``embedMultilevel``, src/embed.cpp:561-796).

Counterpart of graph_embed_tpu/embed/driver.py.  Per level l, coarse to
fine (embed.cpp:576-796):
  1. base case (coarsest): flat ForceAtlas (:582-587);
  2. radii: first-collision sweep over all pairs at the first level below
     the base case (:616-678), over coarse-graph edges inside each
     grandparent further down (:680-756);
  3. renormalize children into their parent balls (:757-777), from the
     second level below the base case on;
  4. refine with the slot-space multilevel ForceAtlas, 100 iterations
     (:786-793).
Level state stays on the chosen device from level to level; only the
radii sweep visits the host, with [m, d] centres.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..forceatlas.flat import force_atlas
from ..forceatlas.multilevel_tiled import prepare_refine, refine_level_tiled
from ..graph.csr import Graph
from ..ops import segment
from ..partition.hierarchy import partition_hierarchy
from ..partition.interpolation import Partition
from ..utils.params import ForceAtlasParams, MultilevelFAParams
from ..utils.timing import MetricsLogger
from .radii import radii_inner, radii_top_level, renormalize_into_parents

# coarsest-level iteration budget: min(params.iterations,
# max(FLOOR, PER_VERTEX * n)), the JAX driver's size-aware default
# (driver.py:62-81) in place of the reference's flat 100000
BASE_ITERS_PER_VERTEX = 12
BASE_ITERS_FLOOR = 10_000


def default_base_iterations(n: int, params: ForceAtlasParams) -> int:
    """Driver default for the coarsest-level iteration count."""
    return min(params.iterations,
               max(BASE_ITERS_FLOOR, BASE_ITERS_PER_VERTEX * n))


def validate_hierarchy(graphs: list[Graph], parts: list[Partition]) -> None:
    """Shape-chain invariants of embed (src/embed.cpp:564-570)."""
    if len(graphs) != len(parts) + 1:
        raise ValueError("need len(graphs) == len(parts) + 1")
    for i, p in enumerate(parts):
        if graphs[i].n != p.n:
            raise ValueError(f"level {i}: graph has {graphs[i].n} vertices "
                             f"but partition maps {p.n}")
        if graphs[i + 1].n != p.num_aggs:
            raise ValueError(f"level {i}: coarse graph has {graphs[i+1].n} "
                             f"vertices but partition makes {p.num_aggs}")


def project_to_levels(coords0: torch.Tensor, parts: list[Partition]):
    """[c_0 ... c_k]: c_0 = coords0 and c_{l+1}[a] = the mean of c_l over
    aggregate a (the warm-start chain).  Each aggregate's sum runs over
    its members in vertex order (``ops.segment``: kernel A on the card)."""
    cs = [coords0]
    for p in parts:
        csr = segment.segment_csr(p.vertex_to_agg_numpy(), p.num_aggs,
                                  device=coords0.device)
        sizes = (csr.indptr[1:] - csr.indptr[:-1]).to(coords0.dtype)
        mean = segment.segment_sum(cs[-1], csr)
        cs.append(mean / torch.clamp(sizes, min=1)[:, None])
    return cs


def _level_seeds(seed: int, k: int) -> dict[int, int]:
    """Per-level generator seeds, derived up front from ``seed``."""
    states = np.random.SeedSequence(int(seed)).generate_state(k + 1,
                                                              np.uint32)
    return {l: int(states[k - l]) for l in range(k + 1)}


def embed(graphs: list[Graph], parts: list[Partition], dim: int = 3, *,
          device, seed: int = 0,
          base_params: ForceAtlasParams | None = None,
          refine_params: MultilevelFAParams | None = None,
          base_iterations: int | None = None,
          refine_iterations: int = 100,
          metrics: MetricsLogger | None = None,
          refine_backend: str = "auto",
          coords0=None,
          on_level: Callable | None = None,
          final_block=None, store=None, mesh=None,
          sharding: str = "replicated") -> torch.Tensor:
    """Multilevel embedding (src/embed.cpp:561-796); returns [n_0, dim]
    coordinates on ``device``.

    graphs: [A_0 ... A_k] with A_{l+1} = P_l^T A_l P_l; parts: [P_0 ...
    P_{k-1}] from ``partition_hierarchy``.  Both move to ``device``.
    ``seed`` seeds one ``torch.Generator`` per level (derived up front).
    ``base_iterations=None`` resolves to ``default_base_iterations``.
    ``refine_backend``: "auto" and "tiled" both run the slot-space
    refinement (kernels A and B on CUDA, their plain versions on the CPU)
    on every level and device.  The JAX driver's auto switch to its
    portable path on CPU backends and small levels (driver.py:247-249) is a
    TPU-only choice; the portable refinement is not ported.
    ``coords0``: optional [n_0, dim] warm start; every level starts from
    its aggregate-mean projection instead of random init.
    ``on_level(l, coords, part, coords_parent, r_parent)`` is called after
    each refined level with its partition and the parent centres and radii
    it was packed into.
    ``metrics`` receives one record per phase (base, radii, layout: the
    host's slot-layout prep, refine).
    """
    if final_block is not None:
        raise NotImplementedError("final_block (embedVia) is not ported yet "
                                  "(ROADMAP queue 1, item 5: via)")
    if store is not None:
        raise NotImplementedError("checkpointing is not ported yet "
                                  "(ROADMAP queue 1, item 5: checkpoint)")
    if mesh is not None or sharding != "replicated":
        raise NotImplementedError("multi-device embedding is not ported yet "
                                  "(ROADMAP queue 1, item 6: parallel/)")
    if refine_backend == "portable":
        raise NotImplementedError("the portable refinement is not ported "
                                  "yet (ROADMAP queue 1, item 3)")
    if refine_backend not in ("auto", "tiled"):
        raise ValueError(f"unknown refine_backend {refine_backend!r}")
    validate_hierarchy(graphs, parts)
    device = torch.device(device)
    graphs = [g.to(device) for g in graphs]
    parts = [p.to(device) for p in parts]
    base_params = base_params or ForceAtlasParams()
    refine_params = refine_params or MultilevelFAParams()
    k = len(parts)
    if base_iterations is None:
        base_iterations = default_base_iterations(graphs[k].n, base_params)
    seeds = _level_seeds(seed, k)
    warm = None
    if coords0 is not None:
        warm = project_to_levels(
            torch.as_tensor(coords0).to(device, graphs[0].dtype), parts)

    metrics = metrics or MetricsLogger()
    with metrics.span("base", device, level=k, n=graphs[k].n):
        coords_A = force_atlas(graphs[k], dim, seed=seeds[k],
                               params=base_params,
                               iterations=base_iterations,
                               coords=warm[k] if warm is not None else None)
    r_Ac = coords_Ac = None
    for l in range(k - 1, -1, -1):
        A_c = graphs[l + 1]
        with metrics.span("radii", device, level=l, m=A_c.n):
            if r_Ac is None:
                s, r, _ = A_c.to_coo_numpy()
                r_A = radii_top_level(coords_A, coarse_edges=(s, r))
            else:
                r_A = radii_inner(coords_A, r_Ac, A_c, parts[l + 1])
                coords_A, r_A = renormalize_into_parents(
                    coords_A, r_A, coords_Ac, r_Ac, parts[l + 1])
        local0 = None
        if warm is not None:
            # the warm fine layout in each aggregate's local frame
            v2a = parts[l].vertex_to_agg
            local0 = ((warm[l] - coords_A[v2a])
                      / torch.clamp(r_A[v2a], min=1e-9)[:, None])
        with metrics.span("layout", device, level=l, n=graphs[l].n):
            layout = prepare_refine(graphs[l], parts[l], refine_params)
        with metrics.span("refine", device, level=l, n=graphs[l].n,
                          num_aggs=parts[l].num_aggs):
            coords = refine_level_tiled(graphs[l], parts[l], coords_A, r_A,
                                        dim, seed=seeds[l],
                                        iterations=refine_iterations,
                                        params=refine_params, layout=layout,
                                        coords0=local0)
        if on_level is not None:
            on_level(l, coords, parts[l], coords_A, r_A)
        coords_Ac, r_Ac = coords_A, r_A
        coords_A = coords
    return coords_A


def embed_graph(g: Graph, dim: int = 3, *, device,
                coarsening_factor: float = 0.1,
                metrics: MetricsLogger | None = None, **embed_kw):
    """Partition with the Galerkin chain emitted, then the multilevel
    embed (the examples/embed.cpp:93-100 pipeline as one call).  Returns
    (coords on ``device``, HierarchyResult)."""
    device = torch.device(device)
    g = g.to(device)
    metrics = metrics or MetricsLogger()
    with metrics.span("partition", device, n=g.n):
        res = partition_hierarchy(g, coarsening_factor, emit_graphs=True)
    coords = embed([g] + res.coarse_graphs, res.levels, dim, device=device,
                   metrics=metrics, **embed_kw)
    return coords, res
