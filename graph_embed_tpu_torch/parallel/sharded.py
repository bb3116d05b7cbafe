"""The replicated multi-shard flat step: edge-sharded attraction and
vertex-block repulsion over replicated coordinates, with every shard
stacked on one device.

Counterpart of graph_embed_tpu/parallel/sharded.py (design notes there).
The sender-sorted edge list is cut into ``ndev`` shards; each shard sums
its edges into a full-length partial attraction, and the partials are
added over the shards in shard order (the reference's ``psum_scatter`` /
``psum``).  Repulsion, gravity and the speed update are vertex-block work
on the replicated coordinates; here every block is a contiguous slice of
one stacked [n_pad, d] tensor, so the blocks' updates run as one operation
over the stack and the ``all_gather`` that re-replicates them is that
tensor read back whole.  The layouts are ``mesh.edge_sharding`` (edge
arrays, the previous forces, vertex blocks) and ``mesh.replicated``
(coordinates, degrees).

* ``pad_graph_for_mesh`` (sharded.py:38-52): the reference's padded edge
  arrays.
* ``make_sharded_fa_step`` (:55-164): the portable step, per-edge gathers,
  ``attraction_fa`` and a row-owned segment sum per shard
  (``ops/segment.py``, kernel A on the card).
* ``build_sharded_tiles`` (:400-520) / ``build_sharded_edge_tiles``
  (:340-385) and ``make_sharded_fa_step_tiled`` (:534-683): one CSR per
  shard over the global vertex space, run by kernel A (kernel E under
  linlog).  The host rules are the reference's and live in
  ``forceatlas/tiled.py`` (``reference_shape``, ``residual_edges``): the
  folded weights, the unit route past ``UNIT_JUMBO_MIN_EDGES`` and its
  shape rule, the bf16 packing's truncated weights with row sums from
  them, the bf16 x gather only on paired unit tiles, the DIA plan with the
  threshold of the reference's lcm-padded vertex count, its edges removed
  from the shards and applied by each vertex block against the replicated
  coordinates (plain ``ops/dia.py:dia_spmv``).  The slab layout, k-groups
  and call chunking are TPU layout and are not carried over.
* ``sharded_force_atlas`` (:170-337): the driver.

Where this departs from the reference, it changes rounding only, never
what is computed:

* the reference cuts the edge list at ceil(e / ndev) per shard
  (:355, :470), so a row can straddle two shards and be summed as two
  partials; here each cut moves forward to the next row start
  (``row_cuts``), so every row has one owning shard and the shard-order
  sum adds only zeros to it;
* repulsion runs over the real rows in chunks whose shapes depend on n
  and the sample count alone (``REP_MAX_PAIRS``), never on the block
  size, and the dense form over the real columns alone (the reference
  gives ghost columns weight 0).

So 1 and 8 shards give the same layout bit for bit.  The per-step
samples are drawn once from a ``torch.Generator`` and shared by every
shard, as the reference shares one ``randint`` (:81, :624); torch cannot
replay threefry, so ``sample_ids`` injects them.

On a mesh that spans processes (``multihost.global_mesh``) each process
builds and runs only its own shards' CSRs and vertex blocks: the shard
sum is the local one followed by an all-reduce (exact, as above), the
repulsion of its rows runs on the same chunks as the one-process step
(whole chunks, the rows of other processes computed and dropped), and
an all-gather re-replicates the updated blocks.  Every rank draws the
same samples, so any split over processes gives the same bits too.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..forceatlas import forces as F
from ..forceatlas import tiled as TL
from ..graph.csr import Graph
from ..ops import dia as DIA
from ..ops import edge_spmm as ES
from ..ops import segment
from ..utils.device import resolve
from ..utils.params import ForceAtlasParams
from .halo import REP_MAX_PAIRS, TILED_MIN_EDGES
from .mesh import ShardMesh, edge_sharding, make_mesh, replicated, round_up

# Largest per-shard dense-repulsion block [blk, n_pad] (bytes of the
# graph's dtype) before sharded_force_atlas switches params.repulsion to
# 'sampled' (sharded.py:162-167).
DENSE_D2_MAX_BYTES = 2 << 30
# folded-unit graphs at least this large take the unit route in
# build_sharded_tiles (sharded.py:395-397)
UNIT_JUMBO_MIN_EDGES = 1_000_000


def pad_graph_for_mesh(g: Graph, n_devices: int, *, edge_multiple: int = 128):
    """Host: the edge arrays padded to a multiple of ``n_devices *
    edge_multiple`` and the vertex count to a multiple of ``n_devices``.
    Returns (senders, receivers, weights, n_pad) numpy arrays; ghost slots
    have sender = receiver = n_pad and weight 0."""
    s, r, w = g.to_coo_numpy()
    e_pad = round_up(max(g.num_edges, 1), n_devices * edge_multiple)
    n_pad = round_up(g.n, n_devices)
    sp = np.full(e_pad, n_pad, dtype=np.int32)
    rp = np.full(e_pad, n_pad, dtype=np.int32)
    wp = np.zeros(e_pad, dtype=np.asarray(w).dtype)
    sp[: g.num_edges] = s
    rp[: g.num_edges] = r
    wp[: g.num_edges] = w
    return sp, rp, wp, n_pad


def row_cuts(senders, n_devices: int) -> np.ndarray:
    """[n_devices + 1] offsets that cut a sender-sorted edge list into
    shards: the reference's cut at ceil(e / n_devices) edges per shard,
    each moved forward to the next row start."""
    s = np.asarray(senders)
    e = s.size
    per = -(-e // n_devices)
    cuts = np.minimum(np.arange(n_devices + 1, dtype=np.int64) * per, e)
    inner = (cuts > 0) & (cuts < e)
    cuts[inner] = np.searchsorted(s, s[cuts[inner] - 1], side="right")
    return cuts


def align_shards(s, r, w, n_pad: int, n_devices: int, *,
                 edge_multiple: int = 128):
    """``pad_graph_for_mesh``'s arrays restacked so that shard d's block
    holds the rows ``row_cuts`` gives it, every block padded with ghost
    edges to one length (a multiple of ``edge_multiple``)."""
    s, r, w = np.asarray(s), np.asarray(r), np.asarray(w)
    live = s < n_pad
    s, r, w = s[live], r[live], w[live]
    cuts = row_cuts(s, n_devices)
    e_blk = round_up(max(int(np.diff(cuts).max(initial=0)), 1),
                     edge_multiple)
    sp = np.full(n_devices * e_blk, n_pad, dtype=np.int32)
    rp = np.full(n_devices * e_blk, n_pad, dtype=np.int32)
    wp = np.zeros(n_devices * e_blk, dtype=w.dtype)
    for d in range(n_devices):
        lo, hi = int(cuts[d]), int(cuts[d + 1])
        o = d * e_blk
        sp[o: o + hi - lo] = s[lo:hi]
        rp[o: o + hi - lo] = r[lo:hi]
        wp[o: o + hi - lo] = w[lo:hi]
    return sp, rp, wp


def _shard_sum(parts: list, mesh: ShardMesh) -> torch.Tensor:
    """The partials of this process's shards added in shard order, then
    over the processes (an all-reduce) where the mesh spans them."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out if mesh.comm is None else mesh.comm.all_reduce(out)


def _repulsion(x, deg_p1, n_real: int, params: ForceAtlasParams, ids,
               rows: tuple[int, int] | None = None):
    """The gram-form repulsion of the real rows [0, n_real) (sharded.py:
    78-110, :622-652): against the shared sample ids under 'sampled',
    scaled by n_real / samples, else against every real row; ghost rows
    get 0.  Full float32 products (TF32 off: the gram identity cancels
    for near pairs).  ``rows`` = (lo, hi) returns only those rows
    ([hi - lo, d]), each computed in the same chunk as for every row."""
    eps = params.epsilon
    sampled = params.repulsion == "sampled"
    if sampled:
        if ids is None:
            raise ValueError("sampled repulsion takes the step's sample ids "
                             "(step.draw or sample_ids)")
        cols = ids.to(x.device, torch.int64)
    else:
        cols = torch.arange(n_real, device=x.device)
    xs = x[cols]
    degs = deg_p1[cols]
    sq_s = torch.sum(xs * xs, dim=1)
    lo, hi = (0, x.shape[0]) if rows is None else rows
    out = x.new_zeros((hi - lo, x.shape[1]))
    per = max(1, REP_MAX_PAIRS // max(int(cols.shape[0]), 1))
    stop = min(hi, n_real)
    for r0 in range(lo - lo % per if lo < stop else stop, stop, per):
        r1 = min(r0 + per, n_real)
        xb = x[r0:r1]
        d2 = (torch.sum(xb * xb, dim=1)[:, None] + sq_s[None, :]
              - 2.0 * torch.matmul(xb, xs.T))
        dist = torch.clamp(torch.sqrt(torch.clamp(d2, min=0.0)), min=eps)
        wgt = degs[None, :] / (dist * dist * dist)
        rows = torch.arange(r0, r1, device=x.device)
        wgt = wgt.masked_fill(rows[:, None] == cols[None, :], 0.0)
        f = xb * torch.sum(wgt, dim=1, keepdim=True) - torch.matmul(wgt, xs)
        rep = (params.repel * deg_p1[r0:r1])[:, None] * f
        if sampled:
            rep = rep * (n_real / int(cols.shape[0]))
        a, b = max(r0, lo), min(r1, hi)
        out[a - lo: b - lo] = rep[a - r0: b - r0]
    return out


class _Step:
    """What every replicated step shares: the vertex blocks, the sample
    draw and the update after the attraction (sharded.py:132-145)."""

    def __init__(self, mesh: ShardMesh, n_pad: int, dim: int,
                 params: ForceAtlasParams, n_real: int):
        # this process's vertex blocks (n_pad must split into them)
        self.lo, self.hi = edge_sharding(mesh).rows(n_pad)
        self.mesh, self.n_pad = mesh, n_pad
        self.params, self.n_real = params, n_real
        self.real = (torch.arange(self.lo, self.hi, device=mesh.device)
                     < n_real)[:, None]

    def draw(self, generator: torch.Generator):
        """One iteration's shared sample ids (None for dense repulsion)."""
        if self.params.repulsion != "sampled":
            return None
        return torch.randint(0, max(self.n_real, 1),
                             (self.params.num_negative_samples,),
                             generator=generator, device=self.mesh.device)

    def _update(self, coords, fprev, deg_p1, att, ids):
        """The update of this process's vertex blocks (``fprev`` and the
        returned forces are theirs), re-replicated (an all-gather where
        the mesh spans processes)."""
        params, lo, hi = self.params, self.lo, self.hi
        x, dp = coords[lo:hi], deg_p1[lo:hi]
        rep = _repulsion(coords, deg_p1, self.n_real, params, ids,
                         rows=(lo, hi))
        grav = F.gravity_force(x, dp, params.gravity)
        f = torch.where(self.real, rep + att[lo:hi] + grav,
                        torch.zeros_like(x))
        new = F.speed_update(x, f, fprev, dp, ks=params.ks,
                             ksmax=params.ksmax, tolerate=params.tolerate)
        new = torch.where(self.real, new, x)
        if self.mesh.comm is not None:
            new = self.mesh.comm.all_gather(new)
        return new, f


@dataclasses.dataclass(frozen=True)
class ShardEdges:
    """The live edges of every shard, shard by shard, on the mesh's
    device; ``csrs[d]`` sums shard d's per-edge values (its slice
    ``bounds[d]:bounds[d + 1]``) into its sender rows."""

    s: torch.Tensor
    r: torch.Tensor
    w: torch.Tensor
    csrs: tuple
    bounds: tuple


class _PortableStep(_Step):
    """The portable step (make_sharded_fa_step): ``step(coords, fprev,
    edges, deg, ids)`` -> (coords', f) with coords [n_pad, dim] and deg
    [n_pad] in ``dtype``, fprev and f this process's vertex blocks
    ([n_pad, dim] in one process); ``edges`` from ``shard_edges``."""

    def __init__(self, mesh, n_pad, e_pad, dim, params, n_real, dtype):
        super().__init__(mesh, n_pad, dim, params, n_real)
        self.e_pad, self.dtype = e_pad, dtype

    def shard_edges(self, s, r, w) -> ShardEdges:
        """The host edge arrays ([e_pad], split into equal blocks, one per
        shard) as this process's shards' live edges and segment CSRs."""
        s, r, w = np.asarray(s), np.asarray(r), np.asarray(w)
        if s.shape[0] != self.e_pad:
            raise ValueError(f"the step takes {self.e_pad} edges, got "
                             f"{s.shape[0]}")
        dev = self.mesh.device
        parts, csrs, bounds = [], [], [0]
        for lo, hi in edge_sharding(self.mesh).blocks(self.e_pad):
            live = s[lo:hi] < self.n_pad
            sd = s[lo:hi][live]
            parts.append((sd, r[lo:hi][live], w[lo:hi][live]))
            csrs.append(segment.segment_csr(sd, self.n_pad, device=dev))
            bounds.append(bounds[-1] + int(sd.size))
        cat = [np.concatenate(a) for a in zip(*parts)]
        return ShardEdges(
            s=torch.from_numpy(cat[0].astype(np.int64)).to(dev),
            r=torch.from_numpy(cat[1].astype(np.int64)).to(dev),
            w=torch.from_numpy(cat[2]).to(dev, self.dtype),
            csrs=tuple(csrs), bounds=tuple(bounds))

    def __call__(self, coords, fprev, edges: ShardEdges, deg, ids=None):
        params = self.params
        deg_p1 = deg + 1.0
        diff = coords[edges.r] - coords[edges.s]
        dist = torch.clamp(torch.sqrt(torch.sum(diff * diff, dim=-1)),
                           min=params.epsilon)
        fa = F.attraction_fa(dist, edges.w, deg_p1[edges.s],
                             linlog=params.linlog, delta=params.delta,
                             nohubs=params.nohubs,
                             use_weights=params.use_weights)
        per_edge = diff * (params.attract * fa / dist)[:, None]
        b = edges.bounds
        att = _shard_sum([segment.segment_sum(per_edge[b[d]: b[d + 1]],
                                              csr)
                          for d, csr in enumerate(edges.csrs)], self.mesh)
        return self._update(coords, fprev, deg_p1, att, ids)


def make_sharded_fa_step(mesh: ShardMesh, n_pad: int, e_pad: int, dim: int,
                         params: ForceAtlasParams, n_real: int,
                         dtype=torch.float32) -> _PortableStep:
    """The portable multi-shard step (sharded.py:55-159); see
    ``_PortableStep``."""
    return _PortableStep(mesh, n_pad, e_pad, dim, params, n_real, dtype)


@dataclasses.dataclass(frozen=True)
class ShardedTiles:
    """The tiled attraction of ``ndev`` shards: ``csrs`` holds those of
    ``shards`` (every shard, or one process's), the CSR of shard d its
    rows (its ``row_cuts`` slice of the residual edges) over the global
    [n_pad] vertex space, with the weights as the reference packs them
    (folded float32 under linlog, for kernel E).  ``deg_w_att`` [n_pad]
    are the row sums the linear form applies, the DIA part included (zero
    under linlog); ``dia_w`` [K, n_pad] the weights of the DIA offsets.
    ``sender_block``, ``window`` and ``n_pad_tiles`` are the tile shape
    and padded vertex count the reference would pick (None under
    linlog); ``packing`` is 'unit', 'bf16' or, under linlog, 'edge'."""

    csrs: tuple
    deg_w_att: torch.Tensor
    n_pad: int
    packing: str
    ndev: int
    shards: range
    linlog: bool = False
    sender_block: int | None = None
    window: int | None = None
    n_pad_tiles: int | None = None
    dia_offsets: tuple = ()
    dia_w: torch.Tensor | None = None


def _fold(g: Graph, s, w, params: ForceAtlasParams | None) -> np.ndarray:
    """The edge weights with the attraction's constants folded in, float32
    (sharded.py:348-353, :433-438); raw without ``params``."""
    if params is None:
        return np.asarray(w)
    deg_send = g.degrees_numpy(params.use_weights)[s]
    return np.asarray(F.fold_edge_weights(
        np.asarray(w, np.float32), deg_send.astype(np.float32),
        use_weights=params.use_weights, delta=params.delta,
        nohubs=params.nohubs), np.float32)


def _mesh_of(n_devices: int, mesh: ShardMesh | None, device) -> ShardMesh:
    """``mesh`` (which must have ``n_devices`` shards), or one process's
    mesh of ``n_devices`` on ``device``."""
    if mesh is None:
        return make_mesh(n_devices, device=device)
    if mesh.ndev != n_devices:
        raise ValueError(f"the mesh has {mesh.ndev} shards, not "
                         f"{n_devices}")
    return mesh


def _shard_csrs(s, r, w, n_pad: int, mesh: ShardMesh, *,
                bf16_gather: bool = False):
    """(one CSR per shard of this process over [n_pad] rows and columns,
    the row sums of every shard added in shard order)."""
    cuts = row_cuts(s, mesh.ndev)
    csrs, sums = [], []
    for d in mesh.local_shards:
        lo, hi = int(cuts[d]), int(cuts[d + 1])
        csr, rs = ES.build_csr(s[lo:hi], r[lo:hi],
                               None if w is None else w[lo:hi], n_pad, n_pad,
                               device=mesh.device, bf16_gather=bf16_gather)
        csrs.append(csr)
        sums.append(rs)
    return tuple(csrs), _shard_sum(sums, mesh)


def build_sharded_tiles(g: Graph, n_devices: int, *, weights=None,
                        sender_block: int | None = None,
                        window: int | None = None,
                        dia_min_count: int | None = 0,
                        params: ForceAtlasParams | None = None,
                        device="cpu",
                        mesh: ShardMesh | None = None) -> ShardedTiles:
    """The sender-sorted edge list cut into ``n_devices`` shards, one CSR
    each over the global vertex space, on ``device`` (sharded.py:400-520);
    with ``mesh`` (of ``n_devices`` shards, on its device) only this
    process's shards.

    ``params`` folds the attraction's constants into the weights (without
    it the raw weights are packed).  All-1.0 folded weights of at least
    ``UNIT_JUMBO_MIN_EDGES`` entries, with no shape given, take the unit
    route: (4096, 8192) tiles past 1.5M vertices, (4096, 16384) under
    ``x_precision='bf16'``, (1024, 2048) for dense graphs (avg degree >=
    128), (4096, 4096) otherwise; everything else the bf16 packing with
    its truncated weights (256 x 256 unless given).  ``dia_min_count``: 0
    plans no DIA offsets, None the auto threshold over the reference's
    lcm-padded vertex count."""
    s, r, w = g.to_coo_numpy()
    if weights is not None:
        w = np.asarray(weights)
    w = _fold(g, s, w, params)
    unit = w.size >= UNIT_JUMBO_MIN_EDGES and bool((w == 1.0).all())
    if unit and sender_block is None and window is None:
        bf16_x = params is not None and params.x_precision == "bf16"
        big = g.n > 1_500_000
        dense = not big and w.size >= 128 * max(g.n, 1)
        sender_block = 1024 if dense else 4096
        window = ((16384 if bf16_x else 8192) if big
                  else (2048 if dense else 4096))
    else:
        unit = False
    sender_block, window, _, n_pad_t = TL.reference_shape(
        g.n, unit, sender_block=sender_block, window=window)
    dia = None
    if dia_min_count is None or dia_min_count > 0:
        dia = DIA.plan_dia(s, r, w, g.n, n_pad=n_pad_t,
                           min_count=dia_min_count)
    rs, rr, rw, paired = TL.residual_edges(
        s, r, w, g.n, unit=unit, dia=dia, sender_block=sender_block,
        window=window)
    mesh = _mesh_of(n_devices, mesh, device)
    dev = mesh.device
    n_pad = round_up(max(n_pad_t, g.n), n_devices)
    csrs, deg_w = _shard_csrs(rs, rr, rw, n_pad, mesh, bf16_gather=paired)
    extra = {}
    if dia is not None:
        dw = np.zeros((len(dia.offsets), n_pad), np.float32)
        dw[:, : g.n] = dia.weights
        deg_w = deg_w + torch.from_numpy(DIA.dia_row_sums(dw)).to(dev)
        extra = dict(dia_offsets=dia.offsets,
                     dia_w=torch.from_numpy(dw).to(dev))
    return ShardedTiles(csrs=csrs, deg_w_att=deg_w, n_pad=n_pad,
                        packing="unit" if unit else "bf16",
                        ndev=n_devices, shards=mesh.local_shards,
                        sender_block=sender_block, window=window,
                        n_pad_tiles=n_pad_t, **extra)


def build_sharded_edge_tiles(g: Graph, n_devices: int, *,
                             params: ForceAtlasParams | None = None,
                             device="cpu",
                             mesh: ShardMesh | None = None) -> ShardedTiles:
    """The linlog counterpart of ``build_sharded_tiles`` (sharded.py:
    340-385): every edge with its folded float32 weight, cut into shards,
    for kernel E; no DIA plan (its rolls encode the linear form only).
    ``mesh`` as there."""
    s, r, w = g.to_coo_numpy()
    w = np.asarray(_fold(g, s, w, params), np.float32)
    mesh = _mesh_of(n_devices, mesh, device)
    n_pad = round_up(max(g.n, 1), n_devices)
    csrs, _ = _shard_csrs(s, r, w, n_pad, mesh)
    return ShardedTiles(csrs=csrs,
                        deg_w_att=torch.zeros(n_pad, device=mesh.device),
                        n_pad=n_pad, packing="edge", ndev=n_devices,
                        shards=mesh.local_shards, linlog=True)


class _TiledStep(_Step):
    """The tiled step (make_sharded_fa_step_tiled): ``step(coords, fprev,
    deg, ids)`` -> (coords', f), float32 [n_pad, dim] and [n_pad], fprev
    and f this process's vertex blocks."""

    def __init__(self, mesh, tiles: ShardedTiles, dim, params, n_real):
        super().__init__(mesh, tiles.n_pad, dim, params, n_real)
        self.tiles = tiles

    def _attraction(self, x):
        params, t = self.params, self.tiles
        if t.linlog:
            return _shard_sum([ES.linlog(x, csr, attract=params.attract,
                                         eps=params.epsilon)
                               for csr in t.csrs], self.mesh)
        if params.x_precision == "bf16" and t.csrs[0].bf16_gather:
            xp = ES.pack_x_bf16(x)     # once for every shard's gather
            parts = [ES.spmv_bf16x(xp, csr, x.shape[1]) for csr in t.csrs]
        else:
            parts = [ES.spmv_windowed(x, csr, x_precision=params.x_precision)
                     for csr in t.csrs]
        att = params.attract * (_shard_sum(parts, self.mesh)
                                - x * t.deg_w_att[:, None])
        if t.dia_offsets:
            # each vertex block's stencil rolls read x[i + o] of the
            # replicated coordinates: no exchange (sharded.py:610-620)
            att = att + params.attract * DIA.dia_spmv(x, t.dia_w,
                                                      t.dia_offsets)
        return att

    def __call__(self, coords, fprev, deg, ids=None):
        att = self._attraction(coords)
        return self._update(coords, fprev, deg + 1.0, att, ids)


def make_sharded_fa_step_tiled(mesh: ShardMesh, tiles: ShardedTiles,
                               dim: int, params: ForceAtlasParams,
                               n_real: int):
    """The multi-shard step with the tiled attraction (sharded.py:534-683):
    returns (``ShardedTiledStep``, n_pad).  ``tiles`` from
    ``build_sharded_tiles`` (or ``build_sharded_edge_tiles`` under
    linlog) for this mesh, on its device."""
    if tiles.ndev != mesh.ndev or tiles.shards != mesh.local_shards:
        raise ValueError(f"the tiles hold shards {tiles.shards} of "
                         f"{tiles.ndev}, the mesh's process "
                         f"{mesh.local_shards} of {mesh.ndev}")
    if tiles.linlog != params.linlog:
        raise ValueError("linlog takes build_sharded_edge_tiles, the linear "
                         "form build_sharded_tiles")
    if tiles.csrs[0].device != torch.empty(0, device=mesh.device).device:
        raise ValueError(f"the tiles live on {tiles.csrs[0].device}, the "
                         f"mesh on {mesh.device}")
    return _TiledStep(mesh, tiles, dim, params, n_real), tiles.n_pad


def resolved_repulsion(g: Graph, ndev: int,
                       params: ForceAtlasParams) -> str:
    """The repulsion ``sharded_force_atlas`` runs on ``g`` over ``ndev``
    shards: ``params.repulsion``, or 'sampled' where the dense block
    [blk, n_pad] in the graph's dtype passes ``DENSE_D2_MAX_BYTES``."""
    n_pad_v = round_up(max(g.n, 1), ndev)
    itemsize = torch.empty(0, dtype=g.dtype).element_size()
    if (params.repulsion != "sampled"
            and itemsize * (n_pad_v // ndev) * n_pad_v > DENSE_D2_MAX_BYTES):
        return "sampled"
    return params.repulsion


def sharded_force_atlas(g: Graph, dim: int = 2, *,
                        mesh: ShardMesh | None = None,
                        params: ForceAtlasParams | None = None,
                        iterations: int = 100, seed: int = 0, coords0=None,
                        tiled: bool | str = "auto", device="cuda",
                        sample_ids=None,
                        tiles: ShardedTiles | None = None) -> torch.Tensor:
    """Flat FA over ``mesh``'s shards (sharded.py:170-240) on ``device``
    (the card by default; it must be the mesh's, one shard without a
    mesh).  Returns [n, dim].

    ``coords0`` warm-starts; otherwise U(-1, 1)^dim is drawn as [n, dim]
    before padding from a ``torch.Generator`` seeded with ``seed``, which
    then draws each iteration's shared samples, unless ``sample_ids``
    gives them.  A dense block [blk, n_pad] past ``DENSE_D2_MAX_BYTES``
    (in the graph's dtype) switches the repulsion to 'sampled'.
    ``tiled``: True runs the attraction on per-shard CSRs (kernel A, or E
    under linlog) and returns float32 cast to the graph's dtype; False the
    portable step in the graph's dtype; "auto" tiled from 100k edges on
    the card.  ``tiles`` passes a prebuilt plan for this mesh and params
    (``build_sharded_tiles(..., dia_min_count=None, params=params)`` or,
    under linlog, ``build_sharded_edge_tiles``); it implies the tiled
    route.  On a mesh that spans processes every rank passes the same
    arguments and returns the same coordinates."""
    params = params or ForceAtlasParams()
    dev = resolve(device)
    mesh = mesh or make_mesh(1, device=dev)
    if mesh.device != dev:
        raise ValueError(f"the mesh lives on {mesh.device}, the step was "
                         f"asked to run on {dev}")
    ndev = mesh.ndev
    repulsion = resolved_repulsion(g, ndev, params)
    if repulsion != params.repulsion:
        params = dataclasses.replace(params, repulsion=repulsion)
    if tiles is not None:
        if tiled is False:
            raise ValueError("prebuilt tiles take the tiled route")
        tiled = True
    if tiled == "auto":
        tiled = g.num_edges >= TILED_MIN_EDGES and dev.type == "cuda"
    g = g.to(dev)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    if coords0 is None:
        x0 = torch.rand((g.n, dim), generator=gen, dtype=g.dtype,
                        device=dev) * 2.0 - 1.0
    else:
        x0 = torch.as_tensor(coords0).to(dev, g.dtype)
    rep, blk = replicated(mesh), edge_sharding(mesh)
    if tiled:
        if tiles is None:
            tiles = (build_sharded_edge_tiles(g, ndev, params=params,
                                              mesh=mesh)
                     if params.linlog else
                     build_sharded_tiles(g, ndev, dia_min_count=None,
                                         params=params, mesh=mesh))
        step, n_pad = make_sharded_fa_step_tiled(mesh, tiles, dim, params,
                                                 g.n)
        dtype, args = torch.float32, ()
    else:
        s, r, w, n_pad = pad_graph_for_mesh(g, ndev)
        s, r, w = align_shards(s, r, w, n_pad, ndev)
        step = make_sharded_fa_step(mesh, n_pad, s.shape[0], dim, params,
                                    g.n, g.dtype)
        dtype, args = g.dtype, (step.shard_edges(s, r, w),)
    coords = rep.put(torch.zeros((n_pad, dim), dtype=dtype))
    coords[: g.n] = x0.to(dtype)
    deg = torch.zeros(n_pad, dtype=dtype, device=dev)
    deg[: g.n] = g.degrees(params.use_weights).to(dtype)
    deg = rep.put(deg)
    fprev = blk.put(torch.zeros((n_pad, dim), dtype=dtype))
    for it in range(iterations):
        ids = step.draw(gen) if sample_ids is None else sample_ids[it]
        coords, fprev = step(coords, fprev, *args, deg, ids)
    return coords[: g.n].to(g.dtype)
