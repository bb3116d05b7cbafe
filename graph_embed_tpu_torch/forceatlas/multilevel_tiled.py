"""Slot-space multilevel refinement (forceAtlasMultilevel,
include/forceatlas.hpp:314-574) on kernels A and B.

Counterpart of graph_embed_tpu/forceatlas/multilevel_tiled.py.  The level
is laid out in *slot space*: aggregates are ordered by (power-of-two size
class S, id) and each occupies S consecutive slots, its members first and
ghost slots after.  Then

* within-aggregate repulsion of every exact bucket is one launch of
  kernel B (``csrc/bucket_repulsion.cu``, members against members over a
  table of warp tasks, ``_task_table``); buckets whose class reaches
  ``sampled_slots_threshold`` use the per-aggregate negative-sampling
  estimator in plain PyTorch;
* intra-aggregate attraction is kernel A (``csrc/edge_spmm.cu``) over a
  slot-space CSR whose weights are truncated to bf16 exactly as the
  reference packer does (unit-weight levels take the unit mode, and under
  ``x_precision='bf16'`` the bf16x mode where the reference pairs its slot
  tiles);
* the cut-edge pull is a per-slot vector computed once per level, its
  per-vertex sums row-owned over the level's sender CSR (kernel A);
* the epilogue (center, max-norm, place into the parent ball,
  forceatlas.hpp:539-570) is per-bucket reshapes, so its sums run in a
  fixed order.

The TPU's VMEM/lane chunk planning (``plan_bucket``) has no counterpart:
buckets are packed back to back with no alignment padding.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..graph.csr import Graph
from ..ops import cuda
from ..ops import edge_spmm as ES
from ..partition.interpolation import Partition
from ..utils.params import MultilevelFAParams
from . import forces as F
from .multilevel import external_pull, sender_csr
from .tiled import UNIT_SENDER_BLOCK, UNIT_TILE, UNIT_WINDOW

# the plain repulsion versions evaluate at most this many pairs at once
PLAIN_MAX_PAIRS = 1 << 24

# the reference's bucket planning (multilevel_tiled.py:79-145), kept only
# to place its slots and count its slab tiling
_VMEM_CHUNK_BUDGET = 10 << 20
_LIVE_BUFFERS = 5
SMALL_MAX_S = 64
ROLL_MAX_S = 16
ROLL_LANES = 16384
CHUNK_LANES = 4096


def bucket_size_classes(counts):
    """Power-of-two size class per aggregate (>= 8)."""
    return np.maximum(8, 1 << np.ceil(np.log2(np.maximum(counts, 1))
                                      ).astype(np.int64))


def size_classes(counts) -> list:
    """(S, aggregate ids) of every size class, the smallest class first and
    the ids ascending in each: the order in which buckets take slots."""
    S_of_agg = bucket_size_classes(counts)
    order = np.lexsort((np.arange(counts.size), S_of_agg))
    S_sorted = S_of_agg[order]
    cuts = np.concatenate([[0], np.flatnonzero(np.diff(S_sorted)) + 1,
                           [counts.size]])
    return [(int(S_sorted[i]), order[i:j])
            for i, j in zip(cuts[:-1], cuts[1:]) if j > i]


def vertex_slots(v2a, counts, start) -> np.ndarray:
    """Each vertex's slot: its aggregate's first slot ``start[a]`` plus its
    rank among the aggregate's members in vertex order."""
    order_v = np.argsort(v2a, kind="stable")
    vstart = np.concatenate([[0], np.cumsum(counts)])
    out = np.zeros(v2a.size, dtype=np.int64)
    out[order_v] = (start[v2a[order_v]] + np.arange(v2a.size)
                    - vstart[v2a[order_v]])
    return out


@dataclasses.dataclass(frozen=True)
class Bucket:
    """The aggregates of one size class: slots [base, base + m_b * S).
    A sampled bucket takes rows [u_row, u_row + m_b) of its class's
    uniforms."""

    base: int
    m_b: int
    S: int
    aggs: torch.Tensor     # [m_b] aggregate ids in slot order
    counts: torch.Tensor   # [m_b] member counts
    sampled: bool
    u_row: int = 0

    @property
    def slots(self) -> slice:
        return slice(self.base, self.base + self.m_b * self.S)


@dataclasses.dataclass(frozen=True)
class RefineLayout:
    """Slot-space layout of one level (built once per level on the host)."""

    slot_of_vertex: torch.Tensor  # [n] vertex -> slot
    valid_slot: torch.Tensor      # [n_slots] bool
    deg_loc: torch.Tensor         # [n_slots] local degree (ghosts 0)
    w_rep: torch.Tensor           # [n_slots] deg_loc + 1, ghosts 0
    csr: ES.EdgeCSR               # intra-aggregate attraction over slots
    deg_w: torch.Tensor           # [n_slots] row sums of csr
    sender_csr: ES.EdgeCSR        # the level's stored entries by sender
    buckets: tuple
    # per sampled size class, smallest first: (its aggregates, the indices
    # of its buckets); the class's uniforms are drawn at once and dealt to
    # its buckets, m_b rows each from ``Bucket.u_row`` (ghost aggregates
    # past the end get zeros), so a class dealt over shards draws as one
    # bucket does
    sampled_classes: tuple
    exact_meta: torch.Tensor      # [tasks, 4] int32 kernel B table
    exact_aggs: torch.Tensor      # [aggregates, 2] int32 its small classes
    n: int
    n_slots: int
    num_aggs: int


def _reference_bucket(S: int, m_b: int) -> tuple[int, int]:
    """(padded aggregate count, base alignment) of one size class in the
    reference's slot layout (plan_bucket, multilevel_tiled.py:112-145)."""
    lane = max(S, 128)
    C_try = (_VMEM_CHUNK_BUDGET // (_LIVE_BUFFERS * S * lane * 4)) // 8 * 8
    if 2 <= S <= SMALL_MAX_S:
        if S > ROLL_MAX_S:
            C = CHUNK_LANES // S
        else:
            c_mult = max(8, 128 // S)
            C = min(ROLL_LANES // S, -(-m_b // c_mult) * c_mult)
        return -(-m_b // C) * C, C * S
    if S <= 256 and C_try >= 8:
        C = min(256, C_try)
        return -(-m_b // C) * C, C * S
    return m_b, S


def _reference_pairs_slots(ss_ref, rr_ref, n_slots_ref: int) -> bool:
    """Whether the reference pairs the unit slot tiling of these intra
    edges (in its own slot ids): their slab count at the unit shape stays
    within one call (multilevel_tiled.py:220-230), so its dispatch takes
    the bf16-pair gather under x_precision='bf16'."""
    count = ES.slab_count(ss_ref, rr_ref, n_slots_ref, UNIT_SENDER_BLOCK,
                          UNIT_WINDOW, UNIT_TILE)
    return count <= ES.MAX_SLABS_PER_CALL


def _task_table(buckets, valid) -> tuple[np.ndarray, np.ndarray]:
    """Kernel B's warp tasks over the exact buckets (csrc/bucket_repulsion
    .cu), one int4 row each, the largest partner count first, and the
    aggregates its small-class tasks walk.  With T = ``cuda.BUCKET_TILE``
    (32):

    * S <= T, rows: (position in the aggregates, S, first row of that
      aggregate, rows): T member rows at a time of the class's aggregates
      of two or more members, listed (first slot, member count) by count,
      largest first, their rows in order;
    * S <= T, zeros: (first slot, -S, slots, mask) per T slots of the
      bucket holding a ghost or the member of a one-member aggregate (bit
      l: slot first + l is written 0);
    * S > T: (the aggregate's first slot, S, first row, member count), per
      T rows of each aggregate.

    Returns ([tasks, 4], [aggregates, 2]) int32.  Member counts come from
    ``valid``, which must hold each aggregate's members first."""
    T = cuda.BUCKET_TILE
    rows, cost, aggs = [], [], []
    n_aggs = 0
    for b in buckets:
        if b.sampled:
            continue
        if b.S < 8 or b.S & (b.S - 1):
            raise ValueError(f"kernel B takes power-of-two classes >= 8, "
                             f"not {b.S}")
        v = valid[b.slots].reshape(b.m_b, b.S)
        counts = v.sum(axis=1)
        if not np.array_equal(v, np.arange(b.S) < counts[:, None]):
            raise ValueError("kernel B needs each aggregate's members first")
        starts = b.base + np.arange(b.m_b, dtype=np.int64) * b.S
        if b.S > T:
            k = b.S // T
            row0 = np.tile(np.arange(k, dtype=np.int64) * T, b.m_b)
            c = np.repeat(counts, k)
            rows.append(np.stack([np.repeat(starts, k),
                                  np.full(row0.size, b.S), row0, c], axis=1))
            cost.append(np.where(row0 < c, c, 0))
            continue
        # zeros: ghosts and one-member aggregates, T slots per mask
        zero = ~v | (counts < 2)[:, None]
        n = -(-zero.size // T)
        bits = np.zeros(n * T, np.int64)
        bits[: zero.size] = zero.reshape(-1)
        mask = (bits.reshape(n, T) << np.arange(T)).sum(axis=1)
        first = b.base + np.arange(n, dtype=np.int64) * T
        live = mask != 0
        rows.append(np.stack([first, np.full(n, -b.S),
                              np.minimum(T, b.slots.stop - first),
                              mask], axis=1)[live])
        cost.append(np.zeros(int(live.sum()), np.int64))
        # rows: the aggregates of 2+ members by count, largest first
        mine = np.flatnonzero(counts >= 2)
        mine = mine[np.argsort(-counts[mine], kind="stable")]
        c = counts[mine]
        ends = np.cumsum(c)
        q0 = np.arange(0, int(ends[-1]) if c.size else 0, T)
        at = np.searchsorted(ends, q0, side="right")
        rows.append(np.stack([n_aggs + at, np.full(q0.size, b.S),
                              q0 - (ends[at] - c[at]),
                              np.minimum(T, ends[-1] - q0) if c.size
                              else q0], axis=1))
        cost.append(c[at])
        aggs.append(np.stack([starts[mine], c], axis=1))
        n_aggs += mine.size
    table = (np.concatenate(rows)[np.argsort(-np.concatenate(cost),
                                             kind="stable")]
             if rows else np.zeros((0, 4)))
    # the masks are 32-bit patterns: wrap bit 31 into int32's sign
    table = table.astype(np.int64)
    table[:, 3] = (table[:, 3] + (1 << 31)) % (1 << 32) - (1 << 31)
    return (table.astype(np.int32),
            np.concatenate(aggs).astype(np.int32) if aggs
            else np.zeros((0, 2), np.int32))


def slot_layout(g: Graph, v2a, counts, params: MultilevelFAParams,
                slot_start, n_slots: int, buckets: list, *, ref_start=None,
                ref_slots: int = 0, vertices=None) -> RefineLayout:
    """The layout of one level from the first slot of every aggregate
    (``slot_start``) and its buckets: vertex slots, the local degrees and
    folded intra-aggregate weights as the reference layout computes them
    (multilevel_tiled.py:199-220), the attraction CSR, the repulsion
    weights.  ``ref_start`` gives the first slots of the reference's own
    layout (``ref_slots`` slots in all): under ``x_precision='bf16'`` a unit
    CSR takes the bf16 gather where that layout's slab count pairs its
    tiles; without it the gather never applies.  ``vertices`` (ascending,
    whole aggregates) lays out only those, ``slot_of_vertex`` then
    listing theirs in that order (one process's shards of
    ``parallel.sharded_ml``).  Host numpy, tensors on ``g``'s device."""
    dev = g.device
    s, r, w = g.to_coo_numpy()
    if vertices is not None:
        # the entries among them, in their order (an intra-aggregate
        # entry has both ends in one aggregate)
        local = np.full(g.n, -1, dtype=np.int64)
        local[vertices] = np.arange(len(vertices))
        keep = (local[s] >= 0) & (local[r] >= 0)
        s, r, w = local[s[keep]], local[r[keep]], np.asarray(w)[keep]
        v2a = np.asarray(v2a)[vertices]
    n = v2a.size
    slot_of_vertex = vertex_slots(v2a, np.bincount(v2a,
                                                   minlength=counts.size),
                                  slot_start)
    valid = np.zeros(n_slots, dtype=bool)
    valid[slot_of_vertex] = True

    both = v2a[s] == v2a[r]
    intra = both & (s != r)
    deg_np = np.bincount(s[both], weights=(np.asarray(w, np.float64)[both]
                                           if params.use_weights else None),
                         minlength=n).astype(np.float64)
    folded = F.fold_edge_weights(w, deg_np[s], use_weights=params.use_weights,
                                 delta=params.delta, nohubs=params.nohubs)
    fw = np.asarray(folded)[intra]
    unit = bool(intra.any()) and bool(np.all(fw == 1.0))
    keep = fw != 0.0
    ss = slot_of_vertex[s[intra][keep]]
    rr = slot_of_vertex[r[intra][keep]]
    paired = False
    if unit and params.x_precision == "bf16" and ref_start is not None:
        # the reference's slots: the same aggregate and member order on its
        # own aligned bucket bases
        ref_slot = vertex_slots(v2a, counts, ref_start)
        paired = _reference_pairs_slots(ref_slot[s[intra]],
                                        ref_slot[r[intra]],
                                        -(-ref_slots // 128) * 128)
    csr, deg_w = ES.build_csr(ss, rr, None if unit else
                              ES.truncate_bf16(fw[keep]), n_slots,
                              device=dev, bf16_gather=paired)

    deg_loc = np.zeros(n_slots, np.float32)
    deg_loc[slot_of_vertex] = deg_np
    w_rep = np.where(valid, deg_loc + 1.0, 0.0).astype(np.float32)
    S_of_agg = bucket_size_classes(counts)
    sampled = sorted({b.S for b in buckets if b.sampled})
    tasks, aggs = _task_table(buckets, valid)
    return RefineLayout(
        slot_of_vertex=torch.from_numpy(slot_of_vertex).to(dev),
        valid_slot=torch.from_numpy(valid).to(dev),
        deg_loc=torch.from_numpy(deg_loc).to(dev),
        w_rep=torch.from_numpy(w_rep).to(dev),
        csr=csr, deg_w=deg_w, sender_csr=sender_csr(g),
        buckets=tuple(buckets),
        sampled_classes=tuple(
            (int((S_of_agg == S).sum()),
             tuple(i for i, b in enumerate(buckets) if b.sampled
                   and b.S == S)) for S in sampled),
        exact_meta=torch.from_numpy(tasks).to(dev),
        exact_aggs=torch.from_numpy(aggs).to(dev),
        n=n, n_slots=n_slots, num_aggs=counts.size)


def prepare_refine(g: Graph, part: Partition,
                   params: MultilevelFAParams) -> RefineLayout:
    """Build the slot layout and the attraction CSR of one level (host
    numpy, tensors placed on ``g``'s device): one bucket per size class,
    back to back."""
    dev = g.device
    v2a = part.vertex_to_agg_numpy()
    m = part.num_aggs
    counts = np.bincount(v2a, minlength=m)
    thr = params.sampled_slots_threshold
    slot_start = np.zeros(m, dtype=np.int64)
    ref_start = np.zeros(m, dtype=np.int64)
    buckets = []
    base = ref_base = 0
    for S, aggs in size_classes(counts):
        m_b = aggs.size
        slot_start[aggs] = base + np.arange(m_b, dtype=np.int64) * S
        m_b_pad, align = _reference_bucket(S, m_b)
        ref_base = -(-ref_base // align) * align
        ref_start[aggs] = ref_base + np.arange(m_b, dtype=np.int64) * S
        ref_base += m_b_pad * S
        buckets.append(Bucket(
            base=int(base), m_b=int(m_b), S=S,
            aggs=torch.from_numpy(aggs.astype(np.int64)).to(dev),
            counts=torch.from_numpy(counts[aggs].astype(np.int64)).to(dev),
            sampled=thr > 0 and S >= thr))
        base += m_b * S
    return slot_layout(g, v2a, counts, params, slot_start, int(base),
                       buckets, ref_start=ref_start, ref_slots=ref_base)


def _pair_sum(xi, xj, wj, skip, eps: float, absolute: bool = False):
    """sum_k wj_k (xi - xj_k) / max(|xi - xj_k|, eps)^3 per slot, over the
    partners k of its aggregate, with diff-form d^2.

    xi: [m, S, d] slots; xj: [m, K, d] partners; wj: [m, K] their weights;
    skip: bool, broadcastable to [m, S, K], masks pairs out.  With
    ``absolute`` the magnitudes of the terms are summed instead."""
    d = xi.shape[-1]
    diff = [xi[:, :, None, k] - xj[:, None, :, k] for k in range(d)]
    d2 = diff[0] * diff[0]
    for k in range(1, d):
        d2 = d2 + diff[k] * diff[k]
    dist = torch.clamp(torch.sqrt(d2), min=eps)
    W = (wj[:, None, :] / (dist * dist * dist)).masked_fill(skip, 0.0)
    terms = [W * diff[k] for k in range(d)]
    if absolute:
        terms = [t.abs() for t in terms]
    return torch.stack([torch.sum(t, dim=2) for t in terms], dim=-1)


def bucket_repulsion_plain(x3, w3, repel: float, eps: float, *,
                           absolute: bool = False):
    """Plain PyTorch version of kernel B on one bucket.

    x3: [m, S, d] slot coordinates; w3: [m, S] weights (deg_loc + 1 on
    members, 0 on ghosts).  Returns repel * w_i * sum_{j != i} w_j
    (x_i - x_j) / max(d_ij, eps)^3 per slot, [m, S, d]; diff-form d^2.
    ``absolute`` sums the terms' magnitudes instead (see
    ``exact_repulsion_plain``)."""
    m, S, _ = x3.shape
    per = max(1, PLAIN_MAX_PAIRS // (S * S))
    eye = torch.eye(S, dtype=torch.bool, device=x3.device)
    out = []
    for a0 in range(0, m, per):
        xs = x3[a0: a0 + per]
        ws = w3[a0: a0 + per]
        out.append(repel * ws[..., None]
                   * _pair_sum(xs, xs, ws, eye, eps, absolute))
    return torch.cat(out, dim=0)


def exact_repulsion_plain(x, layout: RefineLayout, repel: float,
                          eps: float, *, absolute: bool = False
                          ) -> torch.Tensor:
    """Plain version of kernel B over every exact bucket of ``layout``;
    slots of sampled buckets are left at zero.

    With ``absolute`` each slot gets repel * w_i * sum_j |term_ij| per axis
    instead: the size of the float32 rounding in that slot's sum, the
    scale against which kernel B is held to this version element by
    element."""
    d = x.shape[1]
    out = torch.zeros_like(x)
    for b in layout.buckets:
        if b.sampled:
            continue
        sl = b.slots
        out[sl] = bucket_repulsion_plain(
            x[sl].reshape(b.m_b, b.S, d), layout.w_rep[sl].reshape(b.m_b, b.S),
            repel, eps, absolute=absolute).reshape(-1, d)
    return out


def exact_repulsion_cuda(x, layout: RefineLayout, repel: float,
                         eps: float) -> torch.Tensor:
    """Kernel B: one launch over every exact bucket, the warp tasks of
    ``layout.exact_meta`` (``_task_table``): members against members,
    ghost slots written 0.  Slots of sampled buckets are left unwritten
    (the caller fills them)."""
    w, meta, aggs = layout.w_rep, layout.exact_meta, layout.exact_aggs
    if not x.is_cuda or any(t.device != x.device for t in (w, meta, aggs)):
        raise ValueError("kernel B needs x and the layout on one CUDA "
                         "device")
    if (x.dtype != torch.float32 or not x.is_contiguous()
            or x.dim() != 2 or x.shape[0] != layout.n_slots
            or not 1 <= x.shape[1] <= 4):
        raise ValueError(f"kernel B takes contiguous float32 "
                         f"[{layout.n_slots}, d<=4] slot coordinates, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if (meta.dtype != torch.int32 or not meta.is_contiguous()
            or meta.data_ptr() % 16 != 0 or aggs.dtype != torch.int32
            or not aggs.is_contiguous() or aggs.data_ptr() % 8 != 0):
        raise ValueError("kernel B's task table and aggregates must be "
                         "aligned int32")
    out = torch.empty_like(x)
    if meta.shape[0] == 0:
        return out
    with torch.cuda.device(x.device):
        rc = cuda.library().ge_bucket_repulsion(
            meta.shape[0], x.shape[1], meta.data_ptr(), aggs.data_ptr(),
            aggs.shape[0], x.data_ptr(), w.data_ptr(), out.data_ptr(),
            float(repel), float(eps), cuda.stream_of(x))
    cuda.check(rc, "bucket_repulsion")
    cuda.LAUNCHES["bucket_repulsion"] += 1
    return out


def bucket_repulsion_sampled(x3, w3, counts, u, repel: float, eps: float):
    """Per-aggregate negative-sampling repulsion over one bucket
    (multilevel_tiled.py:496-536): partner k of aggregate a is member
    floor(u[a, k] * cnt_a); the estimator of forces.repulsion_sampled with
    n := cnt_a, self pairs masked, scaled by cnt_a / K.

    x3: [m, S, d]; w3: [m, S]; counts: [m]; u: [m, K] uniforms in [0, 1).
    Diff-form distances; returns [m, S, d] (ghosts 0)."""
    m, S, d = x3.shape
    K = u.shape[1]
    cnt = counts.to(u.dtype)
    idx = torch.minimum((u * cnt[:, None]).long(),
                        torch.clamp(counts - 1, min=0)[:, None])
    ys = torch.gather(x3, 1, idx[..., None].expand(m, K, d))   # [m, K, d]
    w_s = torch.gather(w3, 1, idx)                             # [m, K]
    own = torch.arange(S, device=x3.device)[None, :, None]
    per = max(1, PLAIN_MAX_PAIRS // (S * K))
    out = []
    for a0 in range(0, m, per):
        sl = slice(a0, a0 + per)
        acc = _pair_sum(x3[sl], ys[sl], w_s[sl], idx[sl, None, :] == own,
                        eps)
        scale = (cnt[sl] / K)[:, None, None]
        out.append(repel * w3[sl, :, None] * acc * scale)
    return torch.cat(out, dim=0)


def bucket_repulsion(x, layout: RefineLayout, repel: float, eps: float, *,
                     num_samples: int = 256,
                     generator: torch.Generator | None = None
                     ) -> torch.Tensor:
    """[n_slots, d] within-aggregate repulsion in slot space: kernel B
    (CUDA) or its plain version (CPU) on the exact buckets, the sampled
    estimator on the rest, with uniforms drawn from ``generator``."""
    if x.is_cuda:
        out = exact_repulsion_cuda(x, layout, repel, eps)
    elif x.device.type == "cpu":
        out = exact_repulsion_plain(x, layout, repel, eps)
    else:
        raise ValueError(f"bucket_repulsion runs on CUDA or the CPU, not "
                         f"{x.device}")
    d = x.shape[1]
    for m_c, bis in layout.sampled_classes:
        if generator is None:
            raise ValueError("sampled buckets need a generator")
        u = torch.rand((m_c, num_samples), generator=generator,
                       dtype=x.dtype, device=x.device)
        for bi in bis:
            b = layout.buckets[bi]
            ub = u[b.u_row: b.u_row + b.m_b]
            if ub.shape[0] < b.m_b:
                ub = torch.cat([ub, ub.new_zeros((b.m_b - ub.shape[0],
                                                  num_samples))])
            sl = b.slots
            out[sl] = bucket_repulsion_sampled(
                x[sl].reshape(b.m_b, b.S, d),
                layout.w_rep[sl].reshape(b.m_b, b.S), b.counts, ub, repel,
                eps).reshape(-1, d)
    return out


def refine_forces(x, layout: RefineLayout, pull_slot,
                  params: MultilevelFAParams, *,
                  generator: torch.Generator | None = None
                  ) -> torch.Tensor:
    """Total per-slot force of one refinement iteration
    (forceatlas.hpp:390-475): within-aggregate repulsion, intra-aggregate
    attraction, cut-edge pull and gravity, both scaled by 1/max(|x|, eps);
    ghost slots get 0."""
    eps = params.epsilon
    rep = bucket_repulsion(x, layout, params.repel, eps,
                           num_samples=params.num_negative_samples,
                           generator=generator)
    att = ES.attraction_spmv(x, layout.csr, layout.deg_w,
                             attract=params.attract,
                             x_precision=params.x_precision)
    mag = torch.clamp(torch.sqrt(torch.sum(x * x, dim=1)), min=eps)
    ext = pull_slot / mag[:, None]
    grav = -(x / mag[:, None]) * (params.gravity
                                  * (layout.deg_loc + 1.0))[:, None]
    f = rep + att + ext + grav
    return torch.where(layout.valid_slot[:, None], f, torch.zeros_like(f))


def _place_into_parents(x, layout: RefineLayout, coords_A, r_A,
                        eps: float) -> torch.Tensor:
    """Epilogue (forceatlas.hpp:539-570): center each aggregate, scale by
    its max member norm (clamped at eps), place into the parent ball."""
    d = x.shape[1]
    out = torch.zeros_like(x)
    for b in layout.buckets:
        sl = b.slots
        x3 = x[sl].reshape(b.m_b, b.S, d)
        v3 = layout.valid_slot[sl].reshape(b.m_b, b.S)
        mean = (torch.where(v3[..., None], x3, torch.zeros_like(x3))
                .sum(dim=1) / torch.clamp(b.counts, min=1)[:, None].to(x.dtype))
        centered = x3 - mean[:, None, :]
        norms = torch.where(v3, torch.sqrt(torch.sum(centered * centered,
                                                     dim=-1)),
                            torch.zeros_like(v3, dtype=x.dtype))
        mx = torch.clamp(norms.amax(dim=1), min=eps)
        placed = (coords_A[b.aggs][:, None, :]
                  + (r_A[b.aggs] / mx)[:, None, None] * centered)
        out[sl] = torch.where(v3[..., None], placed,
                              torch.zeros_like(placed)).reshape(-1, d)
    return out


def refine_loop(x, layout: RefineLayout, pull_slot,
                params: MultilevelFAParams, iterations: int,
                generator: torch.Generator | None = None) -> torch.Tensor:
    """``iterations`` refinement steps in slot space; returns the slot
    coordinates before the epilogue."""
    eps = params.epsilon
    deg_p1 = layout.deg_loc + 1.0
    valid = layout.valid_slot[:, None]
    fprev = torch.zeros_like(x)
    for _ in range(iterations):
        f = refine_forces(x, layout, pull_slot, params, generator=generator)
        new = F.speed_update(x, f, fprev, deg_p1, ks=params.ks,
                             ksmax=params.ksmax, tolerate=params.tolerate,
                             swing_clamp_eps=eps)
        x = torch.where(valid, new, x)
        fprev = f
    return x


def refine_level_tiled(g: Graph, part: Partition, coords_A, r_A, dim: int,
                       *, seed: int = 0, iterations: int = 100,
                       params: MultilevelFAParams | None = None,
                       layout: RefineLayout | None = None,
                       coords0=None) -> torch.Tensor:
    """Refine one level on ``g``'s device; returns [n, dim] coordinates,
    every vertex inside its aggregate's parent ball.

    Members start at U(-1, 1)^dim from a generator seeded with ``seed``
    (the reference re-randomizes at entry, forceatlas.hpp:356-360), or at
    ``coords0``: [n, dim] warm-start offsets in the local aggregate frame.
    The same generator draws the sampled buckets' partners."""
    params = params or MultilevelFAParams()
    if params.linlog:
        raise NotImplementedError(
            "the slot-space refinement folds attraction into its SpMV and "
            "has no linlog term; refine linlog levels with the portable "
            "refinement (forceatlas.multilevel.force_atlas_multilevel, "
            "which embed takes for every linlog level)")
    dev = g.device
    if layout is None:
        layout = prepare_refine(g, part, params)
    coords_A = torch.as_tensor(coords_A).to(dev, torch.float32)
    r_A = torch.as_tensor(r_A).to(dev, torch.float32)
    pull_v = external_pull(g, part, coords_A, pull=params.pull,
                           eps=params.epsilon, csr=layout.sender_csr)
    pull_slot = torch.zeros((layout.n_slots, dim), dtype=torch.float32,
                            device=dev)
    pull_slot[layout.slot_of_vertex] = pull_v.to(torch.float32)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    if coords0 is None:
        x = (torch.rand((layout.n_slots, dim), generator=gen,
                        dtype=torch.float32, device=dev) * 2.0 - 1.0)
    else:
        x = torch.zeros((layout.n_slots, dim), dtype=torch.float32,
                        device=dev)
        x[layout.slot_of_vertex] = torch.as_tensor(coords0).to(
            dev, torch.float32)
    x = torch.where(layout.valid_slot[:, None], x, torch.zeros_like(x))
    x = refine_loop(x, layout, pull_slot, params, iterations, gen)
    out = _place_into_parents(x, layout, coords_A, r_A, params.epsilon)
    return out[layout.slot_of_vertex]
