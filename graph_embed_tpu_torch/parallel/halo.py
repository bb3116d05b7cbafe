"""Boundary-aware flat ForceAtlas: vertex-partitioned coordinates and a
halo exchange, with every shard stacked on one device.

Counterpart of graph_embed_tpu/parallel/halo.py (module notes there).
Vertices are cut into ``ndev`` contiguous blocks of ``blk`` rows; every
edge lives on its sender's shard, so attraction accumulates locally; per
step each shard exports only its boundary rows (the vertices another shard
receives from), and the sampled repulsion draws a small global sample set.

* ``build_halo_plan`` (halo.py:89-147): the host plan, numpy, the same
  arrays as the reference's.
* ``build_halo_csr`` (halo.py:248-367): the tiled attraction plan.  The
  reference packs per-device window tiles over [blk | pool]; here one CSR
  holds every shard's rows over the stacked space [x | pool] (``ndev *
  blk`` rows of x, then the ``ndev * B_max`` boundary rows), run by kernel
  A in one launch, or by kernel E under linlog.  What the tiles do to the
  arithmetic is kept: unit weights exact, the bf16 packing's weights
  truncated toward zero with row sums from the truncated weights
  (tiled_row_sums), the folded float32 weights of the linlog tiles, the
  local-only tiles under overlap, and the bf16 x gather only where the
  reference pairs unit tiles at a 1024-multiple window.  The reference
  packs with ``min_pair_edges=0``, so no edge is ever diverted to its
  overflow path (the ValueError at :323-325 cannot fire) and the CSR holds
  every edge; its one-call slab limit at ndev > 1 (:333-341) is TPU call
  chunking, not carried over.
* ``make_halo_fa_step`` / ``halo_force_atlas`` (halo.py:370-679): the
  step.  The boundary all_gather is a gather of the export rows of the
  stacked coordinates; the stratified sample set's all_gathers are gathers
  over the shards in shard order; the invariant set's psum of exclusively
  owned samples is a gather of the drawn global rows (each row has one
  owner, so the psum adds only zeros to it).  ``overlap=True`` replaces the
  boundary gather by the ring of ``parallel/overlap.py`` (kernel F).

Attraction runs per edge (segment path: gathers, ``attraction_fa`` and
the row-owned segment sum), or tiled (``tiled="auto"``: at least 100k
edges on the card).  Repulsion is the reference's gram form at full
float32 (``torch.matmul`` with TF32 off), computed over the real rows
[0, n) only -- the real rows of the stacked layout are exactly the
vertices, in order -- in chunks whose shapes depend on n and the sample
count alone, so the invariant mode's layouts are bitwise the same at any
shard count.

On a mesh that spans processes (``multihost.global_mesh``) a process
holds the rows, edges and CSR of its own shards: the boundary pool is an
all-gather of each process's export rows, the stratified sample rows an
all-gather of each process's draws, the invariant ones an all-reduce of
the rows each process owns (each has one owner: only zeros are added),
the ring's hop between processes a send/recv pair, and the repulsion
runs over the process's own real rows on the same chunk grid.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..forceatlas import forces as F
from ..graph.csr import Graph
from ..ops import edge_spmm as ES
from ..ops import segment
from ..utils.device import resolve
from ..utils.params import ForceAtlasParams
from . import overlap as OV
from .mesh import ShardMesh, round_up

SAMPLE_MODES = ("stratified", "invariant")
# the gram repulsion evaluates at most this many (row, sample) pairs at once
REP_MAX_PAIRS = 1 << 26
# tiled="auto" takes the tiled attraction from this many edges (:616-618)
TILED_MIN_EDGES = 100_000


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """Host-built static exchange plan (halo.py:54-86).

    Per-shard arrays are stacked on axis 0.  Receiver indices address the
    concatenation [local block | boundary pool], where the pool is every
    shard's [B_max] export rows, shard by shard."""

    ndev: int
    n: int
    blk: int                   # vertices per shard (padded)
    B_max: int                 # boundary slots per shard (padded, >= 1)
    e_max: int                 # edges per shard (padded)
    senders_loc: np.ndarray    # [ndev, e_max] local sender index (pad blk)
    recv_idx: np.ndarray       # [ndev, e_max] index into [blk | pool]
    weights: np.ndarray        # [ndev, e_max] (pad 0)
    boundary_idx: np.ndarray   # [ndev, B_max] local idx of exported vertices
    boundary_counts: np.ndarray  # [ndev] real exported count per shard
    deg: np.ndarray            # [ndev, blk]
    n_real: np.ndarray         # [ndev, 1] real vertex count per shard

    @property
    def boundary_fraction(self) -> float:
        """Exported-vertex fraction of n (the comm-model B/n)."""
        return float(self.boundary_counts.sum()) / max(self.n, 1)

    def comm_floats_per_step(self, dim: int, num_samples: int) -> int:
        """Floats a step exchanges between shards: the gathered boundary
        and the sample set (coordinates, degree, row id, stratum weight)
        -- against the replicated design's 2 * n_pad * dim."""
        return (self.ndev * self.B_max * dim
                + num_samples * (dim + 3))

    def export_rows(self, shards: range | None = None) -> np.ndarray:
        """[shards * B_max] int64 rows that ``shards`` (every shard by
        default) export, shard by shard, in the stacked coordinates of
        those shards alone: the boundary pool's gather."""
        shards = range(self.ndev) if shards is None else shards
        return (np.arange(len(shards), dtype=np.int64)[:, None] * self.blk
                + self.boundary_idx[shards.start: shards.stop].astype(
                    np.int64)).reshape(-1)


def build_halo_plan(g: Graph, ndev: int, *, block_multiple: int = 8,
                    edge_multiple: int = 8,
                    boundary_multiple: int | None = None) -> HaloPlan:
    """Cut the vertices into ``ndev`` contiguous blocks and build the
    static halo plan.  Reorder the graph first (partition_order,
    rcm_order): the plan's boundary IS the cut of this ordering.
    ``boundary_multiple`` rounds B_max on its own (128 for the ring, as
    ``halo_force_atlas`` asks under overlap; else ``block_multiple``)."""
    s, r, w = g.to_coo_numpy()
    n = g.n
    blk = round_up(max(-(-n // ndev), 1), block_multiple)

    e_dev = np.minimum(s // blk, ndev - 1)
    r_dev = np.minimum(r // blk, ndev - 1)

    # boundary of shard e: owned vertices some OTHER shard receives from
    cross = e_dev != r_dev
    bnd_ids = [np.unique(r[cross & (r_dev == e)]) for e in range(ndev)]
    B_max = max(max((b.size for b in bnd_ids), default=0), 1)
    B_max = round_up(B_max, boundary_multiple or block_multiple)
    boundary_idx = np.zeros((ndev, B_max), np.int32)   # pad with slot 0
    pool_pos = np.full(n, -1, np.int64)                # vertex -> pool slot
    for e in range(ndev):
        ids = bnd_ids[e]
        boundary_idx[e, : ids.size] = (ids - e * blk).astype(np.int32)
        pool_pos[ids] = e * B_max + np.arange(ids.size)

    counts = np.bincount(e_dev, minlength=ndev)
    e_max = round_up(max(int(counts.max()), 1), edge_multiple)
    senders_loc = np.full((ndev, e_max), blk, np.int32)   # pad -> ghost row
    recv_idx = np.zeros((ndev, e_max), np.int32)
    weights = np.zeros((ndev, e_max), np.asarray(w).dtype)
    order = np.argsort(e_dev, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)])
    for e in range(ndev):
        sel = order[starts[e]: starts[e + 1]]
        k = sel.size
        senders_loc[e, :k] = (s[sel] - e * blk).astype(np.int32)
        local = r_dev[sel] == e
        ri = np.where(local, r[sel] - e * blk, blk + pool_pos[r[sel]])
        recv_idx[e, :k] = ri.astype(np.int32)
        weights[e, :k] = w[sel]

    deg = np.zeros((ndev, blk), np.asarray(w).dtype)
    # the row sums in the weight type, added in entry order, as the
    # reference's Graph.degrees (a segment_sum over the stored entries)
    dall = np.zeros(n, np.asarray(w).dtype)
    np.add.at(dall, s, w)
    for e in range(ndev):
        lo = min(e * blk, n)
        hi = min((e + 1) * blk, n)
        if hi > lo:
            deg[e, : hi - lo] = dall[lo:hi]
    n_real = np.array([[max(min((e + 1) * blk, n) - e * blk, 0)]
                       for e in range(ndev)], np.int32)
    return HaloPlan(ndev=ndev, n=n, blk=blk, B_max=B_max, e_max=e_max,
                    senders_loc=senders_loc, recv_idx=recv_idx,
                    weights=weights, boundary_idx=boundary_idx,
                    boundary_counts=np.array([b.size for b in bnd_ids],
                                             np.int64),
                    deg=deg, n_real=n_real)


def _local_space(plan: HaloPlan, shards: range, rows, cols):
    """Stacked [x | pool] indices of ``shards``' edges in the space of
    those shards alone: their x rows first, then the whole pool."""
    off = shards.start * plan.blk
    pool = plan.ndev * plan.blk
    return rows - off, np.where(cols < pool, cols - off,
                                cols - pool + len(shards) * plan.blk)


def _stacked_edges(plan: HaloPlan, senders, recv, weights,
                   local_only: bool):
    """Live edges of every shard over the stacked index spaces: global
    sender rows, receiver columns of [x | pool] (x: ndev * blk rows, then
    the pool), and their weights, shard by shard in plan order (so rows
    stay sorted)."""
    ndev, blk = plan.ndev, plan.blk
    rows, cols, ws = [], [], []
    for e in range(ndev):
        live = senders[e] < blk
        if local_only:
            live &= recv[e] < blk
        s = senders[e][live].astype(np.int64)
        r = recv[e][live].astype(np.int64)
        rows.append(e * blk + s)
        cols.append(np.where(r < blk, e * blk + r, ndev * blk + r - blk))
        ws.append(np.asarray(weights[e][live]))
    return rows, cols, ws


@dataclasses.dataclass(frozen=True)
class HaloCSR:
    """The tiled halo attraction: one CSR of every shard's rows over the
    stacked [x | pool] space ([x] when ``local_only``), and its row sums
    as the linear form applies them (None under linlog: kernel E)."""

    csr: ES.EdgeCSR
    deg_w: torch.Tensor | None
    linlog: bool
    local_only: bool


def build_halo_csr(plan: HaloPlan, params: ForceAtlasParams, *,
                   local_only: bool = False, device="cpu",
                   shards: range | None = None) -> HaloCSR:
    """The tiled attraction plan of ``build_halo_tiles`` as one CSR;
    ``shards`` (one process's, ``ShardMesh.local_shards``) holds only
    their rows, over their own x rows and the whole pool.

    Per-edge constants fold as in the flat tiled path, per shard, in
    float32.  linlog keeps every folded weight (kernel E).  Otherwise unit
    weights (every shard's folded weights 1) take kernel A's unit mode,
    and the rest the bf16 packing's weights, truncated toward zero, zero
    weights dropped.  The bf16 x gather (under ``x_precision="bf16"``)
    applies to the unit mode alone: the reference pairs every unit tiling
    it builds (``jumbo_group`` is 4 or 8, its windows multiples of 1024)
    and no bf16 one."""
    rows, cols, ws = _stacked_edges(plan, plan.senders_loc, plan.recv_idx,
                                    plan.weights, local_only)
    folded = []
    for e, (r_e, w_e) in enumerate(zip(rows, ws)):
        s_loc = r_e - e * plan.blk
        folded.append(np.asarray(F.fold_edge_weights(
            np.asarray(w_e, np.float32),
            np.asarray(plan.deg[e], np.float32)[s_loc],
            use_weights=params.use_weights, delta=params.delta,
            nohubs=params.nohubs), np.float32))
    unit = all(fe.size == 0 or bool((fe == 1.0).all()) for fe in folded)
    shards = range(plan.ndev) if shards is None else shards
    sel = slice(shards.start, shards.stop)
    n_rows = len(shards) * plan.blk
    n_cols = n_rows if local_only else n_rows + plan.ndev * plan.B_max
    rows, cols = _local_space(plan, shards, np.concatenate(rows[sel]),
                              np.concatenate(cols[sel]))
    f = (np.concatenate(folded[sel]) if folded[sel]
         else np.zeros(0, np.float32))
    if params.linlog:
        csr, _ = ES.build_csr(rows, cols, f, n_rows, n_cols, device=device)
        return HaloCSR(csr=csr, deg_w=None, linlog=True,
                       local_only=local_only)
    wt = None
    if not unit:
        keep = f != 0.0
        rows, cols = rows[keep], cols[keep]
        wt = ES.truncate_bf16(f[keep])
    csr, deg_w = ES.build_csr(rows, cols, wt, n_rows, n_cols, device=device,
                              bf16_gather=unit)
    return HaloCSR(csr=csr, deg_w=deg_w, linlog=False, local_only=local_only)


class _HaloStep:
    """One halo FA step over the stacked shards (the shard_map body of
    make_halo_fa_step, halo.py:418-568): ``step(x, fprev, ids)`` ->
    (x', f), x and f [shards * blk, dim] float32 on the mesh's device,
    the rows of this process's shards (every shard in one process).

    ``ids`` are the iteration's sample rows: [ndev, samp_per] local
    indices (stratified: shard s draws from its own nr_s real rows,
    weight nr_s / samp_per) or [K] global vertex ids (invariant: weight
    n / K); ``draw`` makes them from a ``torch.Generator``."""

    def __init__(self, mesh: ShardMesh, plan: HaloPlan, dim: int,
                 params: ForceAtlasParams, *, overlap: bool = False,
                 sample_mode: str = "stratified",
                 tiles: HaloCSR | None = None,
                 groups: OV.OverlapGroups | None = None):
        if sample_mode not in SAMPLE_MODES:
            raise ValueError(f"unknown sample_mode {sample_mode!r}")
        if plan.ndev != mesh.ndev:
            raise ValueError(f"the plan has {plan.ndev} shards, the mesh "
                             f"{mesh.ndev}")
        shards = mesh.local_shards
        if tiles is not None:
            if tiles.csr.n_rows != len(shards) * plan.blk:
                raise ValueError("the halo CSR holds other shards than this "
                                 "process's (build_halo_csr(..., shards="
                                 "mesh.local_shards))")
            if params.linlog != tiles.linlog:
                raise ValueError("linlog needs the linlog halo CSR "
                                 "(build_halo_csr dispatches on "
                                 "params.linlog: rebuild it with the same "
                                 "params)")
            if tiles.local_only != overlap:
                raise ValueError("overlap takes the local-only halo CSR, "
                                 "the collective step the full one")
        if overlap and groups is None:
            groups = OV.build_overlap_groups(plan)
        dev = mesh.device
        self.plan, self.dim, self.params = plan, dim, params
        self.overlap, self.sample_mode, self.tiles = overlap, sample_mode, \
            tiles
        self.ndev, self.blk, self.n = plan.ndev, plan.blk, plan.n
        self.samp_per = max(params.num_negative_samples // plan.ndev, 1)
        self.device, self.comm, self.shards = dev, mesh.comm, shards
        # this process's rows of the stacked coordinates
        self.lo, self.hi = shards.start * plan.blk, shards.stop * plan.blk
        rows = self.hi - self.lo
        self.deg_p1 = torch.from_numpy(
            plan.deg.reshape(-1).astype(np.float32)).to(dev) + 1.0
        self.deg_loc = self.deg_p1[self.lo: self.hi]
        self.real = (torch.arange(self.lo, self.hi, device=dev)
                     < plan.n)[:, None]
        self.n_real = torch.from_numpy(
            plan.n_real[:, 0].astype(np.int64)).to(dev)
        self.bidx = torch.from_numpy(plan.export_rows(shards)).to(dev)
        self.ring = (OV.ring_groups(groups, plan, dev, shards=shards,
                                    comm=mesh.comm) if overlap else None)
        if tiles is None:
            # the portable path: per-edge gathers and the segment sum
            src = ((groups.local_senders, groups.local_recv,
                    groups.local_weights) if overlap else
                   (plan.senders_loc, plan.recv_idx, plan.weights))
            r, c, w = (a[shards.start: shards.stop] for a in _stacked_edges(
                plan, *src, local_only=overlap))
            r, c = _local_space(plan, shards, np.concatenate(r),
                                np.concatenate(c))
            self.edge_s = torch.from_numpy(r).to(dev)
            self.edge_r = torch.from_numpy(c).to(dev)
            self.edge_w = torch.from_numpy(
                np.concatenate(w).astype(np.float32)).to(dev)
            self.edge_csr = segment.segment_csr(r, rows, device=dev)

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every process's ``t`` in rank order (``t`` in one process)."""
        return t if self.comm is None else self.comm.all_gather(t)

    def draw(self, generator: torch.Generator) -> torch.Tensor:
        """One iteration's sample ids from ``generator``."""
        if self.sample_mode == "invariant":
            return torch.randint(0, max(self.n, 1),
                                 (self.params.num_negative_samples,),
                                 generator=generator, device=self.device)
        u = torch.rand((self.ndev, self.samp_per), generator=generator,
                       device=self.device)
        nr = torch.clamp(self.n_real, min=1)[:, None]
        return torch.minimum((u * nr).long(), nr - 1)

    def _attraction(self, x: torch.Tensor) -> torch.Tensor:
        params = self.params
        if self.overlap:
            xcat = x                    # local edges index x only
        else:
            # the halo exchange: only the export rows are gathered
            xcat = torch.cat([x, self._gather(x[self.bidx])], dim=0)
        if self.tiles is None:
            diff = xcat[self.edge_r] - xcat[self.edge_s]
            dist = torch.clamp(torch.sqrt(torch.sum(diff * diff, dim=1)),
                               min=params.epsilon)
            fa = F.attraction_fa(dist, self.edge_w, self.deg_loc[self.edge_s],
                                 linlog=params.linlog, delta=params.delta,
                                 nohubs=params.nohubs,
                                 use_weights=params.use_weights)
            per_edge = diff * (params.attract * fa / dist)[:, None]
            return segment.segment_sum(per_edge, self.edge_csr)
        if self.tiles.linlog:
            return ES.linlog(xcat, self.tiles.csr, attract=params.attract,
                             eps=params.epsilon)
        y = ES.spmv_windowed(xcat, self.tiles.csr,
                             x_precision=params.x_precision)
        return params.attract * (y - x * self.tiles.deg_w[:, None])

    def _samples(self, x: torch.Tensor, ids: torch.Tensor):
        """(xs, rows, weight * deg) of the iteration's sample set; ``x``
        this process's rows, ``rows`` global."""
        if self.sample_mode == "invariant":
            K = self.params.num_negative_samples
            if tuple(ids.shape) != (K,):
                raise ValueError(f"invariant sampling takes [{K}] global "
                                 f"ids, got {tuple(ids.shape)}")
            rows = ids.to(self.device, torch.int64)
            w = torch.full((K,), 1.0, device=self.device) * (
                torch.tensor(float(self.n), device=self.device) / K)
            if self.comm is None:
                return x[rows], rows, self.deg_p1[rows] * w
            # each sample row has one owning process: the others add 0
            own = (rows >= self.lo) & (rows < self.hi)
            mine = x[torch.clamp(rows - self.lo, 0, self.hi - self.lo - 1)]
            xs = self.comm.all_reduce(
                torch.where(own[:, None], mine, torch.zeros_like(mine)))
            return xs, rows, self.deg_p1[rows] * w
        else:
            shape = (self.ndev, self.samp_per)
            if tuple(ids.shape) != shape:
                raise ValueError(f"stratified sampling takes {list(shape)} "
                                 f"local ids, got {tuple(ids.shape)}")
            rows = (torch.arange(self.ndev, device=self.device)[:, None]
                    * self.blk + ids.to(self.device, torch.int64)
                    ).reshape(-1)
            per = torch.full((self.samp_per,), 1.0, device=self.device)
            w = (per[None, :] * (self.n_real.to(torch.float32)
                                 / self.samp_per)[:, None]).reshape(-1)
            mine = rows.view(self.ndev, self.samp_per)[
                self.shards.start: self.shards.stop].reshape(-1)
        return self._gather(x[mine - self.lo]), rows, self.deg_p1[rows] * w

    def _repulsion(self, x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """The gram-form sampled repulsion (halo.py:547-558) on the real
        rows [0, n) of this process's rows ``x``, cut on the chunk grid
        of all rows; the padding rows get 0."""
        eps = self.params.epsilon
        xs, rows_s, dw = self._samples(x, ids)
        sq_s = torch.sum(xs * xs, dim=1)
        out = torch.zeros_like(x)
        per = max(1, REP_MAX_PAIRS // max(xs.shape[0], 1))
        lo, hi = self.lo, min(self.hi, self.n)
        for r0 in range(lo - lo % per if lo < hi else hi, hi, per):
            a, b = max(r0, lo), min(r0 + per, hi)
            xb = x[a - lo: b - lo]
            d2 = (torch.sum(xb * xb, dim=1)[:, None] + sq_s[None, :]
                  - 2.0 * torch.matmul(xb, xs.T))
            dist = torch.clamp(torch.sqrt(torch.clamp(d2, min=0.0)), min=eps)
            wgt = dw[None, :] / (dist * dist * dist)
            rows = torch.arange(a, b, device=x.device)
            wgt = wgt.masked_fill(rows[:, None] == rows_s[None, :], 0.0)
            f = xb * torch.sum(wgt, dim=1, keepdim=True) - torch.matmul(
                wgt, xs)
            out[a - lo: b - lo] = (
                (self.params.repel * self.deg_p1[a:b])[:, None] * f)
        return out

    def __call__(self, x: torch.Tensor, fprev: torch.Tensor,
                 ids: torch.Tensor):
        params = self.params
        att = self._attraction(x)
        if self.overlap:
            fcr = OV.ring_cross_forces(x, self.deg_loc, self.ring, params)
            att = att + segment.segment_sum(fcr.view(-1, x.shape[1]),
                                            self.ring.csr)
        rep = self._repulsion(x, ids)
        grav = F.gravity_force(x, self.deg_loc, params.gravity)
        f = torch.where(self.real, rep + att + grav, torch.zeros_like(x))
        new = F.speed_update(x, f, fprev, self.deg_loc, ks=params.ks,
                             ksmax=params.ksmax, tolerate=params.tolerate)
        return torch.where(self.real, new, x), f


def make_halo_fa_step(mesh: ShardMesh, plan: HaloPlan, dim: int,
                      params: ForceAtlasParams, *, overlap: bool = False,
                      sample_mode: str = "stratified",
                      tiles: HaloCSR | None = None,
                      groups: OV.OverlapGroups | None = None) -> _HaloStep:
    """The halo FA step (halo.py:370-579); see ``_HaloStep``.
    ``overlap=True`` runs the cross edges on the ring (kernel F) and the
    local ones on the segment path or on ``tiles`` built ``local_only``."""
    return _HaloStep(mesh, plan, dim, params, overlap=overlap,
                    sample_mode=sample_mode, tiles=tiles, groups=groups)


def halo_force_atlas(g: Graph, dim: int = 2, *, mesh: ShardMesh,
                     params: ForceAtlasParams | None = None,
                     iterations: int = 100, seed: int = 0, coords0=None,
                     plan: HaloPlan | None = None, overlap: bool = False,
                     sample_mode: str = "stratified",
                     tiled: bool | str = "auto", device="cuda",
                     sample_ids=None) -> torch.Tensor:
    """Flat FA layout with vertex-partitioned coordinates and a
    boundary-only halo exchange (halo.py:582-679), on ``device`` (the
    card by default; it must be the mesh's).  Returns [n, dim].

    ``params.repulsion`` must be 'sampled'.  ``overlap=True`` routes the
    boundary exchange through the ring (kernel F).  ``tiled``: True runs
    the attraction on ``build_halo_csr`` (kernel A, or E under linlog),
    False on the per-edge segment path, "auto" tiled from 100k edges on
    the card.  ``coords0`` warm-starts; otherwise U(-1, 1)^dim from a
    ``torch.Generator`` seeded with ``seed``, which also draws the samples,
    unless ``sample_ids`` gives every iteration's ids (see ``_HaloStep``).
    On a mesh that spans processes every rank passes the same arguments,
    steps its own shards' rows and returns every row."""
    params = params or ForceAtlasParams(repulsion="sampled")
    if params.repulsion != "sampled":
        raise ValueError("halo_force_atlas supports repulsion='sampled' "
                         "only (remote coords are never replicated)")
    dev = resolve(device)
    if mesh.device != dev:
        raise ValueError(f"the mesh lives on {mesh.device}, the step was "
                         f"asked to run on {dev}")
    g = g.to(dev)
    if plan is None:
        plan = build_halo_plan(g, mesh.ndev,
                               boundary_multiple=128 if overlap else None)
    if tiled == "auto":
        tiled = g.num_edges >= TILED_MIN_EDGES and dev.type == "cuda"
    tiles = (build_halo_csr(plan, params, local_only=overlap, device=dev,
                            shards=mesh.local_shards) if tiled else None)
    step = make_halo_fa_step(mesh, plan, dim, params, overlap=overlap,
                             sample_mode=sample_mode, tiles=tiles)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    if coords0 is None:
        x0 = torch.rand((g.n, dim), generator=gen, dtype=torch.float32,
                        device=dev) * 2.0 - 1.0
    else:
        x0 = torch.as_tensor(coords0, dtype=torch.float32).to(dev)
    x = torch.zeros((plan.ndev * plan.blk, dim), dtype=torch.float32,
                    device=dev)
    x[: g.n] = x0
    x = x[step.lo: step.hi]
    fprev = torch.zeros_like(x)
    for it in range(iterations):
        ids = step.draw(gen) if sample_ids is None else sample_ids[it]
        x, fprev = step(x, fprev, ids)
    return step._gather(x)[: g.n]
