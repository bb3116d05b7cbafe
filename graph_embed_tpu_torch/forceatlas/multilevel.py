"""Per-aggregate ForceAtlas refinement, the portable form
(forceAtlasMultilevel, include/forceatlas.hpp:314-574).

Counterpart of graph_embed_tpu/forceatlas/multilevel.py.  One iteration
runs over every vertex of the level at once:

* repulsion only within an aggregate (forceatlas.hpp:394-410).  On a
  CUDA tensor it is one launch of kernel B (``ops.bucket_repulsion``)
  over the level's slot space, members against members with no padded
  pair, for every repulsion name: each pair in the difference form, d^2
  from x_i - x_j with an IEEE sqrt and divide, which is the reference's
  own arithmetic.  The JAX package's gram identity is the TPU's way to
  put this sum on its matrix unit, not a different result; the
  difference form drops its cancellation.  On a CPU tensor it is batched
  [B, S, S] blocks over member tables in power-of-two size classes
  (``build_member_buckets``), in the gram form unless the parameters ask
  for ``"exact"`` per-pair differences, as the JAX package computes them;
  full-float32 matmuls (no TF32, see forces.py).  Each member's force is
  written back by index (every vertex is in one aggregate, so no two
  writes meet);
* intra-aggregate attraction (:415-450) over an intra-aggregate CSR built
  once per level on the host (entries with agg(s) == agg(r), s != r;
  weights folded with the local degrees): kernel A under plain FA,
  ``attract * (A x - x * rowsum)`` in its unit mode when every folded
  weight is 1 and its exact mode otherwise; kernel E under linlog, the
  only attraction of the port with the log term;
* the cut-edge pull (:451-466), a per-vertex vector computed once per
  level, divided by max(|x_i|, eps), and gravity (:411-414, :469-473);
* the epilogue (:539-570): members centred, scaled by their max norm
  (clamped at eps) and placed at coords_A[a] + r_A[a] * x / max.

Every per-vertex or per-aggregate sum runs through ``ops.segment`` or the
kernels' own row-owned walks (no ``index_add_``), so a run on the card is
bitwise repeatable.  On CPU tensors the kernels take their plain versions;
the state keeps the graph's dtype there (float64 in the parity tests).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..graph.csr import Graph
from ..ops import bucket_repulsion as BR
from ..ops import cuda
from ..ops import edge_spmm as ES
from ..ops import segment
from ..partition.interpolation import Partition
from ..utils import timing
from ..utils.device import resolve
from ..utils.params import MultilevelFAParams
from . import forces as F

#: the most [aggregate, member, member] pairs one repulsion chunk holds:
#: a bound on memory, not on the arithmetic (JAX's 256-aggregate,
#: 2M-pair chunk, multilevel.py:187, bounds a TPU scan instead)
PAIR_BUDGET = 1 << 25


def _sorted_members(part: Partition):
    """The vertices sorted by aggregate, on the host: (order, the
    aggregate of each, counts per aggregate, each one's place in its
    aggregate's row); a row lists its vertices in increasing id."""
    v2a = part.vertex_to_agg_numpy()
    order = np.argsort(v2a, kind="stable")
    agg = v2a[order]
    counts = np.bincount(v2a, minlength=part.num_aggs)
    starts = np.concatenate([[0], np.cumsum(counts)])
    return order, agg, counts, np.arange(v2a.shape[0]) - starts[agg]


def _round_up(v: int, k: int) -> int:
    return ((v + k - 1) // k) * k


def build_members(part: Partition, *, pad_multiple: int = 8) -> np.ndarray:
    """[m, S] int32 member table (host): row a lists the vertex ids of
    aggregate a, padded with n; S is the largest aggregate rounded up to
    ``pad_multiple``."""
    order, agg, counts, pos = _sorted_members(part)
    S = max(_round_up(int(counts.max()) if counts.size else 1,
                      pad_multiple), pad_multiple)
    out = np.full((part.num_aggs, S), part.n, dtype=np.int32)
    out[agg, pos] = order
    return out


def build_member_buckets(part: Partition, *,
                         pad_multiple: int = 8) -> tuple[np.ndarray, ...]:
    """Member tables in power-of-two size classes (host int32, padded with
    n): aggregates of at most ``pad_multiple`` members, then at most twice
    that, and so on, so one large aggregate does not pad the many small
    ones.  The classes and widths are the JAX package's.  Each class is
    filled from the vertices sorted by aggregate, so no table is wider than
    its class (a dense [m, largest] table pads every row of a power-law
    level, hundreds of thousands of them, to its largest aggregate)."""
    m, n = part.num_aggs, part.n
    order, agg, counts, pos = _sorted_members(part)
    largest = max(int(counts.max()) if counts.size else 1, 1)
    buckets = []
    lo, cap = -1, pad_multiple
    while lo < largest and m:
        in_b = np.flatnonzero((counts > lo) & (counts <= cap))
        if in_b.size:
            w = min(cap, largest)
            arr = np.full((in_b.size, _round_up(w, pad_multiple)), n,
                          dtype=np.int32)
            row = np.full(m, -1, dtype=np.int64)
            row[in_b] = np.arange(in_b.size)
            sel = row[agg] >= 0
            arr[row[agg[sel]], pos[sel]] = order[sel]
            buckets.append(arr)
        lo, cap = cap, cap * 2
    if not buckets:
        buckets.append(np.full((1, pad_multiple), n, np.int32))
    return tuple(buckets)


def repulsion_members(part: Partition, device) -> tuple | BR.SlotSpace:
    """What ``aggregate_repulsion`` walks for ``part`` on ``device``: kernel
    B's slot space on a card (no member tables), the int64 member tables
    (``build_member_buckets``) elsewhere."""
    device = torch.device(device)
    if device.type == "cuda":
        return BR.slot_space(part.vertex_to_agg_numpy(),
                             part.num_aggs).to(device)
    return tuple(torch.from_numpy(t.astype(np.int64)).to(device)
                 for t in build_member_buckets(part))


def _table_space(tables, n: int) -> BR.SlotSpace:
    """Kernel B's slot space of member tables over ``n`` vertices (host
    arrays or tensors, padded with n): each row an aggregate, which must
    list its members first, and each vertex in no row an aggregate of its
    own, so its force is 0."""
    v2a = np.full(n, -1, dtype=np.int64)
    m = 0
    for t in tables:
        t = torch.as_tensor(t).cpu().numpy()
        member = t < n
        if not np.array_equal(member, np.arange(t.shape[1])
                              < member.sum(axis=1)[:, None]):
            raise ValueError("kernel B needs each aggregate's members first")
        v2a[t[member]] = m + np.nonzero(member)[0]
        m += t.shape[0]
    alone = np.flatnonzero(v2a < 0)
    v2a[alone] = m + np.arange(alone.size)
    return BR.slot_space(v2a, m + alone.size)


def check_full_float32() -> None:
    """The gram form needs full-float32 products: TF32 moves near pairs to
    the eps clamp (forces.py:58-62)."""
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError("the gram-form repulsion needs "
                           "torch.set_float32_matmul_precision('highest') "
                           "(TF32 off)")


def _agg_repulsion_chunk(mem, coords, deg_p1, repel: float, eps: float,
                         exact: bool, absolute: bool = False):
    """Within-aggregate repulsion of a chunk of aggregates: mem [B, S]
    member ids padded with n; returns [B, S, d] (0 on padding).  With
    ``absolute``, each element's rounding scale instead (see
    ``aggregate_repulsion``)."""
    n = coords.shape[0]
    valid = mem < n
    idx = torch.clamp(mem, max=n - 1)
    y = coords[idx]                                        # [B, S, d]
    w = torch.where(valid, deg_p1[idx], torch.zeros((), dtype=coords.dtype,
                                                    device=coords.device))
    S = mem.shape[1]
    skip = (torch.eye(S, dtype=torch.bool, device=coords.device)[None]
            | ~valid[:, None, :])
    if exact:
        diff = y[:, :, None, :] - y[:, None, :, :]         # [B, S, S, d]
        dist = torch.clamp(torch.sqrt(torch.sum(diff * diff, dim=-1)),
                           min=eps)
        W = (w[:, None, :] / (dist * dist * dist)).masked_fill(skip, 0.0)
        if absolute:
            diff = diff.abs()
        f = torch.einsum("bstd,bst->bsd", diff, W)
    else:
        sq = torch.sum(y * y, dim=-1)                      # [B, S]
        d2 = sq[:, :, None] + sq[:, None, :] - 2.0 * torch.bmm(
            y, y.transpose(1, 2))
        dist = torch.clamp(torch.sqrt(torch.clamp(d2, min=0.0)), min=eps)
        W = (w[:, None, :] / (dist * dist * dist)).masked_fill(skip, 0.0)
        if absolute:
            # d^2 from the gram identity is off by a few ulp of
            # |y_i|^2 + |y_j|^2, which W amplifies by that over d^2
            W = W * (1.0 + (sq[:, :, None] + sq[:, None, :])
                     / (dist * dist))
            y_abs = y.abs()
            f = y_abs * torch.sum(W, dim=-1, keepdim=True) + torch.bmm(
                W, y_abs)
        else:
            f = y * torch.sum(W, dim=-1, keepdim=True) - torch.bmm(W, y)
    scale = repel * w
    return (scale.abs() if absolute else scale)[:, :, None] * f


def aggregate_repulsion(coords, members, deg_p1, repel: float, eps: float,
                        *, exact: bool = False, max_pairs: int = PAIR_BUDGET,
                        absolute: bool = False) -> torch.Tensor:
    """[n, d] within-aggregate repulsion (forceatlas.hpp:394-410):
    repel * w_i * sum_{j != i in agg(i)} w_j (x_i - x_j) / max(d_ij, eps)^3
    with w = ``deg_p1``.  ``members``: one [m, S] table or a sequence of
    them (``build_member_buckets``), host arrays or tensors, or kernel B's
    slot space (``repulsion_members`` on a card).

    On a CUDA tensor, or given a slot space: kernel B
    (``BR.vertex_repulsion``; its plain version on a CPU tensor), in the
    difference form whatever ``exact`` says.  Plain tables become a slot
    space here, each row an aggregate (its members first) and each vertex
    in no row one of its own, so the sum is always over the tables
    passed.  No fallback: what kernel B does not take raises.

    On a CPU tensor with tables: each table runs in chunks of at most
    ``max_pairs`` member pairs.  ``absolute`` gives each element's rounding
    scale instead: the sum of its terms' magnitudes, and for the gram form
    each pair's term also scaled by (|x_i|^2 + |x_j|^2) / d_ij^2, the
    cancellation of the gram identity.  Two float32 evaluations in another
    order stay within a small multiple of 2^-24 of it."""
    check_full_float32()
    n, d = coords.shape
    if isinstance(members, (np.ndarray, torch.Tensor)):
        members = (members,)
    if coords.is_cuda or isinstance(members, BR.SlotSpace):
        if absolute:
            raise ValueError("the rounding scales are the member tables' "
                             "plain path's: pass CPU tensors and tables")
        if not isinstance(members, BR.SlotSpace):
            members = _table_space(members, n).to(coords.device)
        return BR.vertex_repulsion(coords, deg_p1, members, repel, eps)
    out = coords.new_zeros((n + 1, d))
    for table in members:
        table = torch.as_tensor(table, device=coords.device).long()
        m, S = table.shape
        per = max(1, max_pairs // max(S * S, 1))
        for a0 in range(0, m, per):
            mem = table[a0: a0 + per]
            f = _agg_repulsion_chunk(mem, coords, deg_p1, repel, eps, exact,
                                     absolute)
            # padding lands in row n, which is dropped
            out[mem.reshape(-1)] = f.reshape(-1, d)
    return out[:n]


def sender_csr(g: Graph) -> ES.EdgeCSR:
    """The segment CSR of ``g``'s stored entries by sender (entry e is
    column e; built on the device from the row pointers)."""
    return segment.sorted_csr(g.indptr, g.num_edges)


def local_degrees(g: Graph, part: Partition, use_weights: bool):
    """deg_i = same-aggregate incident edge weight, self-loops included
    (forceatlas.hpp:362-383)."""
    v2a = part.vertex_to_agg
    same = v2a[g.senders] == v2a[g.receivers]
    val = g.weights if use_weights else torch.ones_like(g.weights)
    val = torch.where(same, val, torch.zeros_like(val))
    return segment.segment_sum(val, sender_csr(g))


def external_pull(g: Graph, part: Partition, coords_A: torch.Tensor, *,
                  pull: float, eps: float,
                  csr: ES.EdgeCSR | None = None) -> torch.Tensor:
    """Per-vertex cut-edge pull (forceatlas.hpp:451-466):
    P_i = sum over stored entries (i, j) with agg(j) != agg(i) of
    pull * (c_{agg j} - c_{agg i}) / max(|c_{agg j} - c_{agg i}|, eps).
    Computed once per level, per entry and then summed per sender (not as
    ``A c - c * rowsum``, which would add a cancellation the reference
    does not have); every per-entry temporary is a flat [E] vector."""
    v2a = part.vertex_to_agg
    a_s = v2a[g.senders]
    a_r = v2a[g.receivers]
    d = coords_A.shape[1]
    diff = [coords_A[:, k][a_r] - coords_A[:, k][a_s] for k in range(d)]
    d2 = diff[0] * diff[0]
    for k in range(1, d):
        d2 = d2 + diff[k] * diff[k]
    dist = torch.clamp(torch.sqrt(d2), min=eps)
    scale = torch.where(a_s != a_r, pull / dist, torch.zeros_like(dist))
    per_entry = torch.stack([diff[k] * scale for k in range(d)], dim=1)
    return segment.segment_sum(per_entry, csr or sender_csr(g))


def _intra_csr(g: Graph, part: Partition, deg_loc: torch.Tensor,
              params: MultilevelFAParams) -> tuple[ES.EdgeCSR, torch.Tensor]:
    """(CSR, row sums) of the intra-aggregate attraction (host build): the
    stored entries with agg(s) == agg(r) and s != r in sender order,
    weights folded by ``forces.fold_edge_weights`` with the local degrees
    (nohubs divides by deg_loc + 1) and kept in the graph's dtype.  Unit
    weights (every folded weight exactly 1) under plain FA give kernel A's
    unit mode; linlog always keeps the weights, as kernel E takes them."""
    s, r, w = g.to_coo_numpy()
    v2a = part.vertex_to_agg_numpy()
    keep = (v2a[s] == v2a[r]) & (s != r)
    s, r = s[keep], r[keep]
    deg_host = deg_loc.cpu().numpy().astype(np.float64)
    c = F.fold_edge_weights(np.asarray(w, np.float64)[keep], deg_host[s],
                            use_weights=params.use_weights,
                            delta=params.delta, nohubs=params.nohubs)
    np_dtype = torch.empty(0, dtype=g.dtype).numpy().dtype
    c = c.astype(np_dtype)
    unit = not params.linlog and bool(np.all(c == 1.0))
    csr, _ = ES.build_csr(s, r, None if unit else c, g.n, device=g.device,
                          exact=True)
    if not unit:
        csr = dataclasses.replace(csr, w=torch.from_numpy(c).to(g.device))
    rowsum = np.bincount(s, weights=None if unit else c.astype(np.float64),
                         minlength=g.n)
    return csr, torch.from_numpy(rowsum.astype(np_dtype)).to(g.device)


@dataclasses.dataclass(frozen=True)
class MultilevelLayout:
    """One level's tables for the portable refinement, built once on the
    host and placed on the graph's device: what the repulsion walks
    (``repulsion_members``: kernel B's slot space on a card, the member
    tables elsewhere), the intra-aggregate CSR and its row sums, the local
    degrees, the sender CSR of the cut-edge pull and the
    members-by-aggregate CSR of the epilogue; and the repulsion's work per
    iteration: ``pairs``, the ordered member pairs sum_a s_a (s_a - 1),
    and ``largest``, the largest aggregate."""

    members: tuple | BR.SlotSpace
    intra: ES.EdgeCSR
    intra_rowsum: torch.Tensor
    deg_loc: torch.Tensor
    sender_csr: ES.EdgeCSR
    agg_csr: ES.EdgeCSR
    vertex_to_agg: torch.Tensor
    num_aggs: int
    pairs: int
    largest: int


def prepare_multilevel(g: Graph, part: Partition,
                       params: MultilevelFAParams) -> MultilevelLayout:
    """The portable refinement's tables of one level (host prep; the local
    degrees are summed on the device by kernel A).  Sub-spans
    ``ml.members`` (``repulsion_members``: on a card kernel B's slot space,
    elsewhere the member tables, built and placed) and ``ml.intra`` (the
    local degrees and the intra-aggregate CSR, with the counter
    ``ml_intra_entries``)."""
    part = part.to(g.device)
    with timing.span("ml.intra"):
        deg_loc = local_degrees(g, part, params.use_weights)
        intra, rowsum = _intra_csr(g, part, deg_loc, params)
        timing.count("ml_intra_entries", int(intra.col.numel()))
    with timing.span("ml.members"):
        members = repulsion_members(part, g.device)
    sizes = part.agg_sizes().cpu().numpy()
    return MultilevelLayout(members=members, intra=intra,
                            intra_rowsum=rowsum, deg_loc=deg_loc,
                            sender_csr=sender_csr(g),
                            agg_csr=part.segment_csr(),
                            vertex_to_agg=part.vertex_to_agg,
                            num_aggs=part.num_aggs,
                            pairs=int(np.sum(sizes * (sizes - 1))),
                            largest=int(sizes.max(initial=0)))


def ml_forces(coords, layout: MultilevelLayout, pull_vec,
              params: MultilevelFAParams, *,
              absolute: bool = False) -> torch.Tensor:
    """Total per-vertex force of one refinement iteration
    (forceatlas.hpp:390-475).  Repulsion on the card is kernel B's
    difference form for every name; on the CPU it takes per-pair
    differences for ``repulsion="exact"`` and the gram form for every other
    name, as the JAX package does (multilevel.py:211).

    ``absolute`` (CPU tensors, plain versions) gives each element's
    rounding scale instead: the sum of the magnitudes of its repulsion
    (``aggregate_repulsion(absolute=True)``), attraction, pull and gravity
    terms, against which the card's forces are held element by
    element."""
    eps = params.epsilon
    deg_p1 = layout.deg_loc + 1.0
    with timing.span("ml.repulsion"):
        rep = aggregate_repulsion(coords, layout.members, deg_p1,
                                  params.repel, eps,
                                  exact=params.repulsion == "exact",
                                  absolute=absolute)
    mag = torch.clamp(torch.sqrt(torch.sum(coords * coords, dim=1)), min=eps)
    ext = pull_vec / mag[:, None]
    grav = -(coords / mag[:, None]) * (params.gravity * deg_p1)[:, None]
    if absolute:
        csr = layout.intra
        if csr.w is not None:
            csr = dataclasses.replace(csr, w=csr.w.abs())
        if params.linlog:
            att = ES.linlog_plain(coords, csr, attract=abs(params.attract),
                                  eps=eps, absolute=True)
        else:
            x_abs = coords.abs()
            att = abs(params.attract) * (
                ES.spmv_plain(x_abs, csr) + x_abs * ES.spmv_plain(
                    torch.ones_like(coords[:, :1]), csr))
        return rep + att + ext.abs() + grav.abs()
    if params.linlog:
        att = ES.linlog(coords, layout.intra, attract=params.attract,
                        eps=eps)
    else:
        att = ES.attraction_spmv(coords, layout.intra, layout.intra_rowsum,
                                 attract=params.attract)
    return rep + att + ext + grav


def ml_loop(x, layout: MultilevelLayout, pull_vec,
            params: MultilevelFAParams, iterations: int) -> torch.Tensor:
    """``iterations`` steps of ``ml_forces`` and the adaptive-speed update
    with the multilevel swing clamp (forceatlas.hpp:477-537)."""
    deg_p1 = layout.deg_loc + 1.0
    fprev = torch.zeros_like(x)
    for _ in range(iterations):
        f = ml_forces(x, layout, pull_vec, params)
        x = F.speed_update(x, f, fprev, deg_p1, ks=params.ks,
                           ksmax=params.ksmax, tolerate=params.tolerate,
                           swing_clamp_eps=params.epsilon)
        fprev = f
    return x


def place_into_parents(x, layout: MultilevelLayout, coords_A, r_A,
                       eps: float) -> torch.Tensor:
    """Epilogue (forceatlas.hpp:539-570): centre each aggregate (its sum
    over members in vertex order), scale by its max member norm (clamped
    at eps; a max does not depend on order) and place into the parent
    ball."""
    v2a = layout.vertex_to_agg
    sizes = (layout.agg_csr.indptr[1:] - layout.agg_csr.indptr[:-1]).to(
        x.dtype)
    mean = segment.segment_sum(x, layout.agg_csr) / torch.clamp(
        sizes, min=1.0)[:, None]
    centered = x - mean[v2a]
    norms = torch.sqrt(torch.sum(centered * centered, dim=1))
    mx = norms.new_zeros(layout.num_aggs).scatter_reduce(
        0, v2a, norms, "amax", include_self=False)
    mx = torch.clamp(mx, min=eps)
    return coords_A[v2a] + (r_A[v2a] / mx[v2a])[:, None] * centered


def force_atlas_multilevel(g: Graph, part: Partition, coords_A, r_A,
                           dim: int, *, seed: int = 0, iterations: int = 100,
                           params: MultilevelFAParams | None = None,
                           layout: MultilevelLayout | None = None,
                           coords0=None, device="cuda") -> torch.Tensor:
    """Refine one level inside the parent balls on ``device`` (the graph,
    partition and parents move there; the card by default, the CPU only
    when asked for) (forceatlas.hpp:314-574; the embed driver runs 100
    iterations, src/embed.cpp:793); returns [n, dim] in the graph's
    dtype.

    Members start at U(-1, 1)^dim from a generator seeded with ``seed``
    (the reference re-randomizes at entry, :356-360), or at ``coords0``:
    [n, dim] warm-start offsets in the local aggregate frame.  ``layout``
    (``prepare_multilevel``, on ``device``) is built here when not
    given.  The sub-span ``ml.loop`` holds the iterations and their card
    work (it ends by waiting on the current stream) and counts the layout's
    ``ml_pairs`` and ``ml_largest_aggregate``, and on the card
    ``ml_repulsion_launches``, the kernel B launches of its iterations (one
    each); each iteration's repulsion is a sub-span ``ml.repulsion`` inside
    it."""
    params = params or MultilevelFAParams()
    g = g.to(resolve(device))
    dev, dtype = g.device, g.dtype
    part = part.to(dev)
    if layout is None:
        layout = prepare_multilevel(g, part, params)
    coords_A = torch.as_tensor(coords_A).to(dev, dtype)
    r_A = torch.as_tensor(r_A).to(dev, dtype)
    pull_vec = external_pull(g, part, coords_A, pull=params.pull,
                             eps=params.epsilon, csr=layout.sender_csr)
    if coords0 is None:
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        x = torch.rand((g.n, dim), generator=gen, dtype=dtype,
                       device=dev) * 2.0 - 1.0
    else:
        x = torch.as_tensor(coords0).to(dev, dtype).contiguous()
    with timing.span("ml.loop", iterations=iterations):
        timing.count("ml_pairs", layout.pairs)
        timing.count("ml_largest_aggregate", layout.largest)
        launched = cuda.LAUNCHES["bucket_repulsion"]
        x = ml_loop(x, layout, pull_vec, params, iterations)
        if dev.type == "cuda":
            timing.count("ml_repulsion_launches",
                         cuda.LAUNCHES["bucket_repulsion"] - launched)
            torch.cuda.current_stream(dev).synchronize()
    return place_into_parents(x, layout, coords_A, r_A, params.epsilon)
