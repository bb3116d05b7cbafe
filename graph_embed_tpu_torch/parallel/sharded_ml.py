"""The multilevel refinement with aggregates dealt to shards.

Counterpart of graph_embed_tpu/parallel/sharded_ml.py (design notes
there).  Every piece of a refinement iteration is local to the aggregate,
so one iteration needs no exchange between shards.  Aggregates are
bucketed into power-of-two size classes by the single-device rule and
dealt contiguously to the shards within each class
(``ops.bucket_repulsion.slot_space``): aggregate k of a class of m_c goes
to shard k // q at rank k % q, q = ceil(m_c / ndev).  Every shard's local
slot space then has the same structure (the same classes, q aggregates
each, ghost aggregates where a shard runs out), and the shards are
stacked, device major, into one slot space that kernels A and B run in
one launch each.

The TPU's per-bucket VMEM/lane planning (``plan_bucket``) and the 128-slot
rounding of the local space are TPU layout, not carried over: classes sit
back to back.  What must not depend on the shard count does not:

* per-aggregate arithmetic: kernel B walks each slot's aggregate, kernel A
  each slot's row, in an order fixed by the aggregate alone;
* draws: the random start is drawn per vertex, and the sampled classes'
  uniforms per aggregate in class order, then dealt like the aggregates
  (``SlotSpace.sampled_classes``);
* the epilogue's mean is a row-owned segment sum over each aggregate's
  members (``ops/segment.py``), its max norm a max.

So a level refined on 1 and on 8 shards is bitwise the same (the JAX
package pins this, tests/test_sharded_ml.py:52).

On a mesh that spans processes (``multihost.global_mesh``) each process
lays out and refines only its own shards' slots (whole aggregates, so no
exchange during the iterations; every rank draws the whole start and
every sampled class's uniforms, and keeps its part), and one all-gather
of the placed slots, device major, gives every rank the level.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..forceatlas import multilevel_tiled as MT
from ..forceatlas.multilevel import external_pull
from ..graph.csr import Graph
from ..ops import edge_spmm as ES
from ..ops import segment
from ..partition.interpolation import Partition
from ..utils.params import MultilevelFAParams
from .mesh import ShardMesh


@dataclasses.dataclass(frozen=True)
class ShardedRefineLayout:
    """The device-major slot layout of one level over ``ndev`` shards.

    ``layout`` is a RefineLayout over the stacked slot space of
    ``shards`` (every shard, or one process's: shard d owns slots
    [(d - shards.start) * n_slots_local, ...) of it, n_slots_local each);
    its buckets are one per (shard, class), shard major, ghost aggregates
    carrying the id ``num_aggs`` and count 0.  ``members`` sums each
    aggregate's member slots in slot order; ``agg_of_slot`` [n_slots]
    (ghost slots ``num_aggs``).  ``vertices`` are the laid-out vertices
    (None: every vertex)."""

    ndev: int
    n_slots_local: int
    layout: MT.RefineLayout
    members: ES.EdgeCSR
    agg_of_slot: torch.Tensor
    shards: range
    vertices: torch.Tensor | None


def prepare_refine_sharded(g: Graph, part: Partition,
                           params: MultilevelFAParams, ndev: int, *,
                           shards: range | None = None
                           ) -> ShardedRefineLayout:
    """Deal the aggregates of one level to ``ndev`` shards and build the
    stacked slot layout of ``shards`` (every shard by default; one
    process's, ``ShardMesh.local_shards``) (host numpy, tensors on
    ``g``'s device).  The reference's sharded tiles are never paired, so
    no bf16 gather."""
    dev = g.device
    shards = range(ndev) if shards is None else shards
    # one host copy of the aggregate map, for the layout and for here
    v2a = part.vertex_to_agg_numpy()
    part = dataclasses.replace(part, host_v2a=v2a)
    layout = MT.slot_layout(g, part, params, ndev=ndev, shards=shards)
    m, n_slots = part.num_aggs, layout.n_slots
    vertex = layout.space.vertex.cpu().numpy()
    live = np.flatnonzero(vertex < g.n)
    agg_of_slot = np.full(n_slots, m, dtype=np.int64)
    agg_of_slot[live] = v2a[vertex[live]]
    # each aggregate's member slots, in slot order (a stable sort by id)
    members, _ = ES.build_csr(agg_of_slot[live], live, None, m, n_slots,
                              device=dev)
    return ShardedRefineLayout(
        ndev=ndev, n_slots_local=n_slots // len(shards), layout=layout,
        members=members, agg_of_slot=torch.from_numpy(agg_of_slot).to(dev),
        shards=shards,
        vertices=(None if len(shards) == ndev
                  else torch.from_numpy(np.sort(vertex[live])).to(dev)))


def _place_into_parents(x, shl: ShardedRefineLayout, coords_A, r_A,
                        eps: float) -> torch.Tensor:
    """The epilogue (forceatlas.hpp:539-570) with its sums row-owned:
    center each aggregate on its member mean, scale by its max member
    norm (clamped at eps), place into the parent ball; ghosts get 0."""
    layout = shl.layout
    m = shl.members.n_rows
    valid = layout.valid_slot[:, None]
    cnt = (shl.members.indptr[1:] - shl.members.indptr[:-1]).to(x.dtype)
    mean = segment.segment_sum(x, shl.members) / torch.clamp(
        cnt, min=1)[:, None]
    agg = torch.clamp(shl.agg_of_slot, max=m - 1)
    centered = x - mean[agg]
    norms = torch.where(layout.valid_slot,
                        torch.sqrt(torch.sum(centered * centered, dim=1)),
                        torch.zeros_like(x[:, 0]))
    mx = torch.zeros(m + 1, dtype=x.dtype, device=x.device).scatter_reduce(
        0, shl.agg_of_slot, norms, "amax")[:m]
    mx = torch.clamp(mx, min=eps)
    placed = coords_A[agg] + (r_A[agg] / mx[agg])[:, None] * centered
    return torch.where(valid, placed, torch.zeros_like(placed))


def make_refine_sharded_step(mesh: ShardMesh, shl: ShardedRefineLayout,
                             dim: int, params: MultilevelFAParams,
                             iterations: int):
    """The whole-level refinement (sharded_ml.py:225-301): ``step(x, pull,
    coords_A, r_A, generator)`` runs ``iterations`` refinement iterations
    on the stacked slot coordinates ``x`` [n_slots, dim] with no exchange
    between shards, then the epilogue, and returns the placed slots
    (ghosts 0)."""
    if shl.ndev != mesh.ndev or shl.shards != mesh.local_shards:
        raise ValueError(f"the layout holds shards {shl.shards} of "
                         f"{shl.ndev}, the mesh's process "
                         f"{mesh.local_shards} of {mesh.ndev}")

    def step(x, pull_slot, coords_A, r_A, generator):
        if x.shape != (shl.layout.n_slots, dim):
            raise ValueError(f"the step takes [{shl.layout.n_slots}, {dim}] "
                             f"slot coordinates, got {tuple(x.shape)}")
        x = MT.refine_loop(x, shl.layout, pull_slot, params, iterations,
                           generator)
        return _place_into_parents(x, shl, coords_A, r_A, params.epsilon)

    return step


def refine_level_sharded(g: Graph, part: Partition, coords_A, r_A, dim: int,
                         *, mesh: ShardMesh, seed: int = 0,
                         iterations: int = 100,
                         params: MultilevelFAParams | None = None,
                         layout: ShardedRefineLayout | None = None,
                         coords0=None) -> torch.Tensor:
    """Refine one level with its aggregates dealt over ``mesh``'s shards
    (sharded_ml.py:304-369) on the mesh's device; returns [n, dim].

    The start is U(-1, 1)^dim per vertex from a generator seeded with
    ``seed`` (which also draws the sampled classes' partners), or
    ``coords0``: [n, dim] warm-start offsets in the local aggregate frame.
    The same seed gives the same layout at any shard count, and on a mesh
    that spans processes every rank returns it."""
    params = params or MultilevelFAParams()
    if params.linlog:
        raise NotImplementedError(
            "the sharded refinement folds attraction into its SpMV and has "
            "no linlog term; the reference's refine_level_sharded drops it "
            "silently (reference fault 8, ROADMAP queue 3), the port "
            "raises")
    dev = mesh.device
    g, part = g.to(dev), part.to(dev)
    if layout is None:
        layout = prepare_refine_sharded(g, part, params, mesh.ndev,
                                        shards=mesh.local_shards)
    step = make_refine_sharded_step(mesh, layout, dim, params, iterations)
    lay = layout.layout
    eps = params.epsilon
    coords_A = torch.as_tensor(coords_A).to(dev, torch.float32)
    r_A = torch.as_tensor(r_A).to(dev, torch.float32)
    pull_v = external_pull(g, part, coords_A, pull=params.pull, eps=eps,
                           csr=lay.sender_csr)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    if coords0 is None:
        c0 = torch.rand((g.n, dim), generator=gen, dtype=torch.float32,
                        device=dev) * 2.0 - 1.0
    else:
        c0 = torch.as_tensor(coords0).to(dev, torch.float32)
    if layout.vertices is not None:
        pull_v, c0 = pull_v[layout.vertices], c0[layout.vertices]
    pull_slot = torch.zeros((lay.n_slots, dim), dtype=torch.float32,
                            device=dev)
    pull_slot[lay.slot_of_vertex] = pull_v.to(torch.float32)
    x = torch.zeros((lay.n_slots, dim), dtype=torch.float32, device=dev)
    x[lay.slot_of_vertex] = c0
    placed = step(x, pull_slot, coords_A, r_A, gen)
    if mesh.comm is not None:
        placed = mesh.comm.all_gather(placed)
    return placed[lay.space.slot]
