"""Flat ForceAtlas2 layout (include/forceatlas.hpp:89-312): the multilevel
embed's base case.  Counterpart of graph_embed_tpu/forceatlas/flat.py.

One iteration reads coords and writes coords in separate phases
(forces -> swing/speed -> displacement), a Python loop over
``fa_step``.  Plain-FA attraction is ``attract * (A_c x - deg_c * x)`` with
the folded constants c_e (forces.fold_edge_weights) in float32: on a CUDA
device it runs through kernel A.  linlog attraction keeps the per-edge
distance and runs through kernel E over the same CSR.  Both kernels own one
row per thread and sum in CSR order, so the card's result is bitwise
repeatable.  ``repulsion="centroids"`` takes the far field of a grouping
(``farfield.py``); without one, ``force_atlas`` builds the JAX package's
default, ``partition_num_parts(g, max(32, n // 64))``.

On a CUDA device a loop of at least ``GRAPH_MIN_ITERATIONS`` iterations
replays a CUDA graph: the iteration makes no host synchronisation and
no control flow that depends on data (the reference pins the global
swing and traction to 1.0).  ``GRAPH_WARMUP`` eager iterations warm up
the lazy state (cuBLAS handles and workspaces, the kernel library); one
chunk of ``GRAPH_CHUNK`` iterations is captured over the warm-up's
coords and forces, which the chunk's last step writes back in place; the
graph replays until fewer than ``GRAPH_CHUNK`` iterations are left, and
those run eagerly.  A replay runs the eager loop's kernels in its order,
so the layout is the eager loop's bit for bit.  Sampled repulsion draws
from the loop's ``torch.Generator``, registered with the graph, so a
replay's draws are the eager loop's too.

``GRAPH_CHUNK`` = 2, measured on an H100 80GB HBM3 (700 W) over 10,000
iterations of mesh3d(128)'s 56-vertex base case, where the eager loop's
~40 launches take the host 840-950 us an iteration against ~90 us of
card time: the card took 85.2-88.4 us an iteration at chunks of 2, 88.5
at 1 (a graph launch's own gap) and 93.6-95.1 at 4 to 32, while a
replay's enqueue took the host 4-9 us at every chunk up to 16, far below
the card's time for it, so the card is never starved; the capture costs
the host 1-2 ms an iteration captured.

``ops.cuda.LAUNCHES`` counts a replay's kernels as the capture counted
them.  The ``base.loop`` sub-span counts ``base_graph_iterations`` and
``base_graph_replays``, and ``base_attraction_entries`` (the entries of
the attraction CSR each iteration walks), and ends by waiting on the
current stream: replays return to the host long before the card finishes
them, and the sub-span holds the loop's card work.
"""

from __future__ import annotations

import collections
import dataclasses

import torch

from ..graph.csr import Graph
from ..ops import cuda
from ..ops import edge_spmm as ES
from ..partition.hierarchy import partition_num_parts
from ..utils import timing
from ..utils.device import resolve
from ..utils.params import ForceAtlasParams
from . import farfield as FF
from . import forces as F

#: iterations captured in one CUDA graph, measured on an H100 (module
#: docstring): a replay's enqueue stays below its card time
GRAPH_CHUNK = 2
#: eager iterations before the capture (lazy initialisation)
GRAPH_WARMUP = 2
#: the fewest iterations that replay a graph: the capture costs the host
#: about a chunk of eager iterations, paid back by the first replays
GRAPH_MIN_ITERATIONS = GRAPH_WARMUP + 2 * GRAPH_CHUNK
# the side stream of every capture on a card, by device index
_CAPTURE_STREAMS: dict = {}


@dataclasses.dataclass(frozen=True)
class FlatAttraction:
    """The attraction operator of one graph under one parameter set: the
    folded-weight CSR and its row sums (the row sums serve plain FA only)."""

    csr: ES.EdgeCSR
    deg_c: torch.Tensor
    attract: float
    eps: float
    linlog: bool

    @classmethod
    def build(cls, g: Graph, params: ForceAtlasParams) -> "FlatAttraction":
        s, r, w = g.to_coo_numpy()
        deg = g.degrees_numpy(params.use_weights)
        c = F.fold_edge_weights(w, deg[s], use_weights=params.use_weights,
                                delta=params.delta, nohubs=params.nohubs)
        csr, deg_c = ES.build_csr(s, r, c, g.n, device=g.device)
        return cls(csr=csr, deg_c=deg_c.to(g.dtype), attract=params.attract,
                   eps=params.epsilon, linlog=params.linlog)

    def __call__(self, coords: torch.Tensor, g: Graph) -> torch.Tensor:
        if self.linlog:
            return ES.linlog(coords, self.csr, attract=self.attract,
                             eps=self.eps)
        return ES.attraction_spmv(coords, self.csr, self.deg_c,
                                  attract=self.attract)


def compute_forces(coords, g: Graph, deg, params: ForceAtlasParams, *,
                   attraction: FlatAttraction | None = None,
                   generator: torch.Generator | None = None,
                   sample_idx: torch.Tensor | None = None, groups=None):
    """Total force per vertex for one iteration (forceatlas.hpp:146-212).
    Sampled repulsion takes ``sample_idx`` or draws it from
    ``generator``; centroids repulsion takes ``groups`` (a
    ``farfield.Groups``, built once per layout)."""
    deg_p1 = deg + 1.0
    eps = params.epsilon
    if params.repulsion == "exact":
        rep = F.repulsion_exact(coords, deg_p1, params.repel, eps)
    elif params.repulsion == "gram":
        rep = F.repulsion_gram(coords, deg_p1, params.repel, eps)
    elif params.repulsion == "sampled":
        if sample_idx is None:
            if generator is None:
                raise ValueError("sampled repulsion needs a generator")
            sample_idx = torch.randint(0, g.n, (params.num_negative_samples,),
                                       generator=generator,
                                       device=coords.device)
        rep = F.repulsion_sampled(coords, deg_p1, params.repel, eps,
                                  sample_idx)
    elif params.repulsion == "centroids":
        if groups is None:
            raise ValueError("centroids repulsion needs its groups "
                             "(farfield.Groups)")
        rep = FF.centroid_repulsion(coords, deg_p1, groups, params.repel,
                                    eps)
    else:
        raise ValueError(f"unknown repulsion {params.repulsion!r}")
    if attraction is None:
        attraction = FlatAttraction.build(g, params)
    att = attraction(coords, g)
    grav = F.gravity_force(coords, deg_p1, params.gravity)
    return rep + att + grav


def fa_step(coords, forces_prev, g: Graph, deg, params: ForceAtlasParams,
            *, attraction: FlatAttraction | None = None,
            generator: torch.Generator | None = None,
            sample_idx: torch.Tensor | None = None, groups=None):
    """One full iteration; returns (coords', forces)."""
    f = compute_forces(coords, g, deg, params, attraction=attraction,
                       generator=generator, sample_idx=sample_idx,
                       groups=groups)
    new_coords = F.speed_update(coords, f, forces_prev, deg + 1.0,
                                ks=params.ks, ksmax=params.ksmax,
                                tolerate=params.tolerate)
    return new_coords, f


def force_atlas(g: Graph, dim: int = 2, *, coords=None, seed: int = 0,
                params: ForceAtlasParams | None = None,
                iterations: int | None = None, groups=None,
                device="cuda") -> torch.Tensor:
    """Flat ForceAtlas layout on ``device`` (the graph moves there; the
    card by default, the CPU only when asked for).

    ``coords`` warm-starts the layout (forceatlas.hpp:118-125); otherwise
    U(-1, 1)^dim init from a ``torch.Generator`` seeded with ``seed``,
    which also draws the sampled repulsion's partners.  ``groups`` (a
    Partition) are the centroids repulsion's; by default
    ``partition_num_parts(g, max(32, n // 64))`` (flat.py:153-157).
    ``x_precision`` has no effect here, as in the reference's flat.py."""
    params = params or ForceAtlasParams()
    if iterations is None:
        iterations = params.iterations
    g = g.to(resolve(device))
    gen = torch.Generator(device=g.device).manual_seed(int(seed))
    if coords is None:
        coords = (torch.rand((g.n, dim), generator=gen, dtype=g.dtype,
                             device=g.device) * 2.0 - 1.0)
    else:
        coords = torch.as_tensor(coords, dtype=g.dtype).to(g.device)
    deg = g.degrees(params.use_weights)
    attraction = FlatAttraction.build(g, params)
    if params.repulsion == "centroids":
        if groups is None:
            groups = partition_num_parts(g, max(32, g.n // 64))
        groups = FF.Groups.build(groups, g.device)
    forces_prev = torch.zeros_like(coords)

    def step(x, f):
        return fa_step(x, f, g, deg, params, attraction=attraction,
                       generator=gen, groups=groups)

    with timing.span("base.loop", iterations=iterations):
        timing.count("base_attraction_entries",
                     int(attraction.csr.col.numel()))
        if g.device.type == "cuda" and iterations >= GRAPH_MIN_ITERATIONS:
            coords, forces_prev = _replay_loop(
                step, coords, forces_prev, iterations,
                gen if params.repulsion == "sampled" else None)
        else:
            for _ in range(iterations):
                coords, forces_prev = step(coords, forces_prev)
        if g.device.type == "cuda":
            torch.cuda.current_stream(g.device).synchronize()
    if params.normalize:
        coords = F.normalize_coords(coords)
    return coords


def _replay_loop(step, coords, forces_prev, iterations: int,
                 generator: torch.Generator | None):
    """``iterations`` of ``step`` on the card: the warm-up, replays of one
    captured chunk, the tail (module docstring).  ``generator`` is the one
    the steps draw from, if any."""
    for _ in range(GRAPH_WARMUP):
        coords, forces_prev = step(coords, forces_prev)
    replays, tail = divmod(iterations - GRAPH_WARMUP, GRAPH_CHUNK)
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)
    before = collections.Counter(cuda.LAUNCHES)
    # capture on a side stream without torch.cuda.graph's synchronize
    # and empty_cache: the capture runs nothing, the replays run on the
    # current stream after the warm-up.  One stream per card: cuBLAS keeps
    # a workspace for each stream it has run on.
    dev = coords.device
    if dev.index not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[dev.index] = torch.cuda.Stream(dev)
    with torch.cuda.stream(_CAPTURE_STREAMS[dev.index]):
        graph.capture_begin()
        try:
            x, f = coords, forces_prev
            for _ in range(GRAPH_CHUNK):
                x, f = step(x, f)
            coords.copy_(x)
            forces_prev.copy_(f)
        finally:
            graph.capture_end()
    per_replay = cuda.LAUNCHES - before
    cuda.LAUNCHES.clear()
    cuda.LAUNCHES.update(before)
    for _ in range(replays):
        graph.replay()
        cuda.LAUNCHES.update(per_replay)
    timing.count("base_graph_iterations", replays * GRAPH_CHUNK)
    timing.count("base_graph_replays", replays)
    for _ in range(tail):
        coords, forces_prev = step(coords, forces_prev)
    return coords, forces_prev
