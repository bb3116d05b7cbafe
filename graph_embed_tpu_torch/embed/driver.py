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
  4. refine with the multilevel ForceAtlas, 100 iterations (:786-793):
     the slot-space refinement, or the portable one
     (``forceatlas.multilevel``), which every linlog level takes.
Level state stays on the chosen device from level to level; only the
radii sweep visits the host, with [m, d] centres.  With a checkpoint store
each level is saved as it completes and a rerun resumes after the last
completed level.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..forceatlas.flat import force_atlas
from ..forceatlas.multilevel import force_atlas_multilevel, prepare_multilevel
from ..forceatlas.multilevel_tiled import prepare_refine, refine_level_tiled
from ..graph.csr import Graph
from ..graph.reorder import apply_order, partition_order
from ..ops import segment
from ..ops.spgemm import coarsen_graph, coarsen_graph_device
from ..parallel.halo import halo_force_atlas
from ..parallel.sharded import resolved_repulsion, sharded_force_atlas
from ..parallel.sharded_ml import (prepare_refine_sharded,
                                   refine_level_sharded)
from ..partition.hierarchy import partition_hierarchy
from ..partition.interpolation import Partition
from ..utils.device import resolve
from ..utils import timing
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
        csr = p.to(coords0.device).segment_csr()
        sizes = (csr.indptr[1:] - csr.indptr[:-1]).to(coords0.dtype)
        mean = segment.segment_sum(cs[-1], csr)
        cs.append(mean / torch.clamp(sizes, min=1)[:, None])
    return cs


#: each refinement route's (layout prep, refine level)
_ROUTES = {"tiled": (prepare_refine, refine_level_tiled),
           "portable": (prepare_multilevel, force_atlas_multilevel),
           "sharded": (prepare_refine_sharded, refine_level_sharded)}


def _level_seeds(seed: int, k: int) -> dict[int, int]:
    """Per-level generator seeds, derived up front from ``seed``."""
    states = np.random.SeedSequence(int(seed)).generate_state(k + 1,
                                                              np.uint32)
    return {l: int(states[k - l]) for l in range(k + 1)}


def embed(graphs: list[Graph], parts: list[Partition], dim: int = 3, *,
          device="cuda", seed: int = 0,
          base_params: ForceAtlasParams | None = None,
          refine_params: MultilevelFAParams | None = None,
          base_iterations: int | None = None,
          refine_iterations: int = 100,
          metrics: MetricsLogger | None = None,
          refine_backend: str = "auto",
          coords0=None,
          on_level: Callable | None = None,
          final_block=None, store=None, mesh=None,
          mesh_min_n: int = 65536, sharding: str = "replicated",
          base_order=None) -> torch.Tensor:
    """Multilevel embedding (src/embed.cpp:561-796); returns [n_0, dim]
    coordinates on ``device``.

    graphs: [A_0 ... A_k] with A_{l+1} = P_l^T A_l P_l; parts: [P_0 ...
    P_{k-1}] from ``partition_hierarchy``.  Both move to ``device``.
    ``seed`` seeds one ``torch.Generator`` per level (derived up front).
    ``base_iterations=None`` resolves to ``default_base_iterations``.
    ``refine_backend``: "auto" and "tiled" both run the slot-space
    refinement (kernels A and B on CUDA, their plain versions on the CPU)
    on every level and device; "portable" runs
    ``forceatlas.multilevel.force_atlas_multilevel`` (member tables, kernel
    A).  Every level whose ``refine_params.linlog`` is set takes the
    portable refinement, whatever the backend (driver.py:267-279): it
    alone has the log term (kernel E).  The JAX driver's auto switch to
    its portable path on CPU backends and small levels (driver.py:247-249)
    is a TPU-only choice.
    ``coords0``: optional [n_0, dim] warm start; every level starts from
    its aggregate-mean projection instead of random init.
    ``on_level(l, coords, part, coords_parent, r_parent)`` is called after
    each refined level with its partition and the parent centres and radii
    it was packed into.
    ``metrics`` receives one record per phase (base with the repulsion it
    ran, radii, layout: the host's layout prep, refine with its ``route``;
    "resume" when a store supplies levels) and is the current logger for
    the call (``utils.timing.use``): the phases' records carry the
    sub-spans, counts and kernel launches made inside them.
    ``final_block`` replaces level 0's refinement with a building block
    (``via.any_to_multilevel``; the embedViaMultilevel hook,
    src/embed.cpp:332), called as ``final_block(A_0, P_0, coords_A, r_A,
    dim, seed=...)``.
    ``store`` (``checkpoint.CheckpointStore``) saves each level as it
    completes; a store that holds levels k, k-1, ..., l resumes from
    level l.  The per-level seeds are derived up front, so a resumed embed
    equals a fresh one.
    ``mesh`` (``parallel.mesh.make_mesh``, on ``device``): levels of at
    least ``mesh_min_n`` vertices refine with their aggregates dealt over
    the mesh's shards (``parallel.sharded_ml``), and a coarsest level that
    large runs a multi-shard flat step: with ``sharding="replicated"``
    (the default) the replicated step (``parallel.sharded``: edge-sharded
    attraction, the level's base parameters, tiled from 100k edges on the
    card), with ``sharding="halo"`` the halo step (partition-ordered,
    vertex-partitioned, invariant sampling; ``base_order`` gives its
    ordering, new position -> old id, instead of partitioning the level
    again).  Both give the same layout at any shard count.  Linlog
    refinement with a mesh raises, before the base case, where a level to
    refine has at least ``mesh_min_n`` vertices: the reference's sharded
    refinement has no log term (reference fault 8, ROADMAP queue 3).
    Every other linlog level takes the portable refinement, as without a
    mesh.  A mesh from ``parallel.multihost.global_mesh`` spans processes:
    every rank runs the same levels and returns the same coordinates.
    """
    if sharding not in ("replicated", "halo"):
        # a typo must not fall through to another design
        raise ValueError(f"unknown sharding {sharding!r}; "
                         "expected 'replicated' or 'halo'")
    if refine_backend not in ("auto", "tiled", "portable"):
        raise ValueError(f"unknown refine_backend {refine_backend!r}")
    refine_params = refine_params or MultilevelFAParams()
    validate_hierarchy(graphs, parts)
    k = len(parts)
    resume_from = store.last_completed(k) if store is not None else None
    start = k - 1 if resume_from is None else resume_from - 1
    refined = [l for l in range(start + 1)
               if not (l == 0 and final_block is not None)]
    if (mesh is not None and refine_params.linlog
            and any(graphs[l].n >= mesh_min_n for l in refined)):
        raise NotImplementedError(
            "linlog refinement of a level of at least mesh_min_n vertices: "
            "the reference's sharded refinement folds attraction into its "
            "SpMV tiles and drops the log term (reference fault 8, ROADMAP "
            "queue 3), and the port does not copy it")
    metrics = metrics or MetricsLogger()
    with timing.use(metrics):
        device = resolve(device)
        if mesh is not None and mesh.device != device:
            raise ValueError(f"the mesh lives on {mesh.device}, the embed "
                             f"runs on {device}")
        graphs = [g.to(device) for g in graphs]
        parts = [p.to(device) for p in parts]
        base_params = base_params or ForceAtlasParams()
        if base_iterations is None:
            base_iterations = default_base_iterations(graphs[k].n, base_params)
        seeds = _level_seeds(seed, k)

        def warm_start():
            # a card-only partition's maps go to the host here: inside the
            # first phase, or counted on the resume record
            if coords0 is None:
                return None
            return project_to_levels(
                torch.as_tensor(coords0).to(device, graphs[0].dtype), parts)

        r_Ac = coords_Ac = None
        if resume_from is not None:
            data = store.load_level(resume_from)

            def load(name):
                return torch.from_numpy(data[name]).to(device, graphs[0].dtype)

            coords_A = load("coords")
            if "r_A" in data:
                r_Ac, coords_Ac = load("r_A"), load("coords_parent")
            warm = warm_start()
            metrics.log(phase="resume", level=resume_from)
        else:
            on_mesh = mesh is not None and graphs[k].n >= mesh_min_n
            params_k = base_params
            if on_mesh:
                # the halo step samples always; the replicated step drops to
                # sampling where its dense block would not fit
                params_k = dataclasses.replace(base_params, repulsion=(
                    "sampled" if sharding == "halo" else
                    resolved_repulsion(graphs[k], mesh.ndev, base_params)))
            with metrics.span("base", device, level=k, n=graphs[k].n,
                              repulsion=params_k.repulsion):
                warm = warm_start()
                warm_k = warm[k] if warm is not None else None
                if on_mesh:
                    if sharding == "halo":
                        coords_A = _halo_base_case(
                            graphs[k], dim, mesh, params_k, base_iterations,
                            seeds[k], warm_k, order=base_order)
                    else:
                        coords_A = sharded_force_atlas(
                            graphs[k], dim, mesh=mesh, params=params_k,
                            iterations=base_iterations, seed=seeds[k],
                            coords0=warm_k, device=mesh.device)
                else:
                    coords_A = force_atlas(graphs[k], dim, seed=seeds[k],
                                           params=base_params,
                                           iterations=base_iterations,
                                           coords=warm_k, device=device)
            if store is not None:
                store.save_level(k, coords=coords_A)
        portable = refine_backend == "portable" or refine_params.linlog
        for l in range(start, -1, -1):
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
            span = dict(level=l, n=graphs[l].n, num_aggs=parts[l].num_aggs)
            if l == 0 and final_block is not None:
                with metrics.span("refine", device, route="final_block",
                                  **span):
                    coords = final_block(graphs[0], parts[0], coords_A, r_A,
                                         dim, seed=seeds[0])
            else:
                sharded = mesh is not None and graphs[l].n >= mesh_min_n
                route = ("sharded" if sharded else
                         "portable" if portable else "tiled")
                prepare, refine = _ROUTES[route]
                with metrics.span("layout", device, level=l, n=graphs[l].n):
                    layout = prepare(graphs[l], parts[l], refine_params,
                                     **(dict(ndev=mesh.ndev,
                                             shards=mesh.local_shards)
                                        if sharded else {}))
                with metrics.span("refine", device, route=route, **span):
                    coords = refine(graphs[l], parts[l], coords_A, r_A, dim,
                                    seed=seeds[l],
                                    iterations=refine_iterations,
                                    params=refine_params, layout=layout,
                                    coords0=local0,
                                    **({"mesh": mesh} if sharded else
                                       {"device": device}
                                       if route == "portable" else {}))
            if on_level is not None:
                on_level(l, coords, parts[l], coords_A, r_A)
            if store is not None:
                # what a resume below this level needs: its coordinates, the
                # parent radii and the renormalized parent centres
                store.save_level(l, coords=coords, r_A=r_A,
                                 coords_parent=coords_A)
            coords_Ac, r_Ac = coords_A, r_A
            coords_A = coords
        return coords_A


def _halo_base_case(g: Graph, dim: int, mesh, params: ForceAtlasParams,
                    iterations: int, seed: int, warm, order=None):
    """The boundary-aware base case (driver.py:293-328): partition-order
    the level so the shard cut is small (or take ``order``), run the halo
    step with invariant sampling (the same layout at any shard count), and
    undo the order.  ``params.repulsion`` must be 'sampled' (``embed``
    sets it)."""
    perm = np.asarray(order) if order is not None else partition_order(g)
    if perm.shape[0] != g.n:
        raise ValueError(f"base_order has {perm.shape[0]} entries for a "
                         f"{g.n}-vertex coarsest level")
    if order is not None and np.bincount(perm, minlength=g.n).max() != 1:
        raise ValueError("base_order is not a permutation of range(n)")
    g_ord, inv = apply_order(g, perm)
    warm_ord = None
    if warm is not None:
        warm_ord = warm[torch.from_numpy(perm).to(warm.device)]
    out = halo_force_atlas(g_ord, dim, mesh=mesh, params=params,
                           iterations=iterations, seed=seed,
                           coords0=warm_ord, sample_mode="invariant",
                           device=mesh.device)
    return out[torch.from_numpy(inv).to(out.device)]


def build_galerkin_chain(g: Graph, parts: list[Partition], *,
                         backend: str | None = None) -> list[Graph]:
    """[A_0 ... A_k] by repeated P^T A P (examples/embed.cpp:95-98;
    driver.py:331-356 of the JAX package), built where ``g`` lives.

    A graph with a host COO (read from a file, made on the host) is
    coarsened on the host (``ops.spgemm.coarsen_graph``: duplicates summed
    in float64, then rounded to the graph's dtype).  A graph without one
    (drawn or kept on its device) is coarsened on its device
    (``coarsen_graph_device``: one stable sort and one kernel A launch a
    level, ``ops.spgemm.run_sums``), and each coarse level then gets its
    host COO by one copy of the finished level (``graph_to_host_bytes``
    on a card), which the radii and the layout prep read.  Integer
    weights (unit weights and every level above them) are summed exactly
    on either side, so the two chains are equal there; other weights
    agree to the graph's rounding.  The counter ``galerkin_card_levels``
    reads the levels built on the device.  ``backend`` ("host" or
    "device") overrides the choice."""
    if backend is None:
        backend = "host" if g.host_coo is not None else "device"
    if backend not in ("host", "device"):
        raise ValueError(f"unknown backend {backend!r}")
    graphs = [g]
    for p in parts:
        if backend == "device":
            a = coarsen_graph_device(graphs[-1], p.vertex_to_agg, p.num_aggs)
            graphs.append(dataclasses.replace(a, host_coo=a.to_coo_numpy()))
        else:
            graphs.append(coarsen_graph(graphs[-1], p.vertex_to_agg_numpy(),
                                        p.num_aggs))
    timing.count("galerkin_card_levels",
                 len(parts) if backend == "device" else 0)
    return graphs


def embed_graph(g: Graph, dim: int = 3, *, device="cuda",
                coarsening_factor: float = 0.1,
                metrics: MetricsLogger | None = None, **embed_kw):
    """Partition, Galerkin chain, multilevel embed (the
    examples/embed.cpp:93-100 pipeline as one call).  The hierarchy takes
    the native coarsener, which emits the chain, when ``g`` has a host COO,
    and the device coarsener otherwise; the chain then comes from
    ``build_galerkin_chain``, which builds it where ``g`` lives.
    ``metrics`` is the current logger for the call, as in ``embed``.
    Returns (coords on ``device``, HierarchyResult)."""
    device = resolve(device)
    metrics = metrics or MetricsLogger()
    with timing.use(metrics):
        g = g.to(device)
        with metrics.span("partition", device, n=g.n):
            res = partition_hierarchy(g, coarsening_factor, emit_graphs=True)
        if res.coarse_graphs is not None:
            graphs = [g] + res.coarse_graphs
        else:
            with metrics.span("galerkin", device, levels=len(res.levels)):
                graphs = build_galerkin_chain(g, res.levels)
        coords = embed(graphs, res.levels, dim, device=device,
                       metrics=metrics, **embed_kw)
    return coords, res
