"""Pluggable multilevel embedding: ``anyToMultilevel`` (src/embed.cpp:
23-83), ``embedVia`` (:85-106) and ``embedViaMultilevel`` (:108-335).

Counterpart of graph_embed_tpu/embed/via.py.  ``any_to_multilevel`` wraps
a flat embedder ``(graph, dim, seed=...) -> coords`` into the multilevel
building block: per aggregate, the induced subgraph with a unit weight per
stored entry (embed.cpp:62) is embedded flat, scaled by its max norm
without centring (:67-74) and placed at ``coords_A[a] + r_A[a] * x / max``
(:75-79).  Each aggregate's seed is derived up front from the block's seed
(``np.random.SeedSequence``), where the JAX package splits its key.

Reference quirk kept: the recursion for coarse levels calls the ForceAtlas
multilevel driver (embed.cpp:144 recurses into ``embedMultilevel``), so the
supplied embedder acts on the finest level only; with no coarse level the
whole graph is one aggregate in the unit ball (:121-138).
"""

from __future__ import annotations

import numpy as np
import torch

from ..graph.csr import Graph, from_edges
from ..partition.interpolation import Partition
from ..utils.params import ForceAtlasParams, MultilevelFAParams


def any_to_multilevel(flat_embedder):
    """(graph, dim, seed=...) -> coords  =>  the building block
    (graph, part, coords_A, r_A, dim, seed=0) -> coords on the graph's
    device."""

    def block(g: Graph, part: Partition, coords_A, r_A, dim: int, *,
              seed: int = 0) -> torch.Tensor:
        s, r, _ = g.to_coo_numpy()
        v2a = part.vertex_to_agg_numpy()
        cA = torch.as_tensor(coords_A).cpu().numpy()
        rA = torch.as_tensor(r_A).cpu().numpy()
        coords = np.zeros((g.n, dim), dtype=cA.dtype)
        indptr, order = part.members_csr()
        # a vertex's index inside its aggregate (members in vertex order)
        local = np.empty(g.n, dtype=np.int64)
        local[order] = np.arange(g.n) - indptr[v2a[order]]
        seeds = np.random.SeedSequence(int(seed)).generate_state(
            max(part.num_aggs, 1), np.uint32)
        # the entries inside an aggregate, grouped by it in stored order
        inside = np.flatnonzero(v2a[s] == v2a[r])
        inside = inside[np.argsort(v2a[s[inside]], kind="stable")]
        bounds = np.searchsorted(v2a[s[inside]],
                                 np.arange(part.num_aggs + 1))
        for a in range(part.num_aggs):
            v = order[indptr[a]:indptr[a + 1]]
            e = inside[bounds[a]:bounds[a + 1]]
            sub = from_edges(local[s[e]], local[r[e]], np.ones(e.size),
                             n=v.size, dtype=g.dtype, device=g.device)
            new = torch.as_tensor(flat_embedder(sub, dim,
                                                seed=int(seeds[a])))
            new = new.detach().cpu().numpy()
            with np.errstate(over="ignore"):   # inf scales the block to 0
                mx = np.sqrt((new ** 2).sum(axis=1)).max()
            if mx <= 0:
                mx = 1.0
            coords[v] = cA[a][None, :] + rA[a] * (new / mx)
        return torch.from_numpy(coords).to(g.device, g.dtype)

    return block


def embed_via(graphs: list[Graph], parts: list[Partition], dim: int,
              embedder_block, *, device, seed: int = 0,
              base_params: ForceAtlasParams | None = None,
              refine_params: MultilevelFAParams | None = None,
              base_iterations: int | None = None,
              refine_iterations: int = 100) -> torch.Tensor:
    """Generic multilevel embed (src/embed.cpp:85-106, :108-335):
    ``embedder_block`` (the signature ``any_to_multilevel`` gives) replaces
    the finest level's refinement; coarser levels run the ForceAtlas
    recursion (embed.cpp:144)."""
    from .driver import embed, validate_hierarchy

    validate_hierarchy(graphs, parts)
    if not parts:
        g = graphs[0].to(device)
        part = Partition.from_numpy(np.zeros(g.n, np.int32), 1,
                                    device=g.device)
        return embedder_block(g, part, torch.zeros((1, dim), dtype=g.dtype),
                              torch.ones(1, dtype=g.dtype), dim, seed=seed)
    return embed(graphs, parts, dim, device=device, seed=seed,
                 base_params=base_params, refine_params=refine_params,
                 base_iterations=base_iterations,
                 refine_iterations=refine_iterations,
                 final_block=embedder_block)
