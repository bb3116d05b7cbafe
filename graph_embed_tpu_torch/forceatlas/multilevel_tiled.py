"""Slot-space multilevel refinement (forceAtlasMultilevel,
include/forceatlas.hpp:314-574) on kernels A and B.

Counterpart of graph_embed_tpu/forceatlas/multilevel_tiled.py.  The level
is laid out in kernel B's *slot space* (``ops.bucket_repulsion``):
aggregates are ordered by (power-of-two size class S, id) and each
occupies S consecutive slots, its members first and ghost slots after.
Then

* within-aggregate repulsion of every exact bucket is one launch of
  kernel B (members against members over the space's warp tasks);
  buckets whose class reaches ``sampled_slots_threshold`` use the
  per-aggregate negative-sampling estimator in plain PyTorch;
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
from ..ops import bucket_repulsion as BR
from ..ops import edge_spmm as ES
from ..partition.interpolation import Partition
from ..utils import timing
from ..utils.params import MultilevelFAParams
from . import forces as F
from .multilevel import external_pull, sender_csr
from .tiled import UNIT_SENDER_BLOCK, UNIT_TILE, UNIT_WINDOW

# the reference's bucket planning (multilevel_tiled.py:79-145), kept only
# to place its slots and count its slab tiling
_VMEM_CHUNK_BUDGET = 10 << 20
_LIVE_BUFFERS = 5
SMALL_MAX_S = 64
ROLL_MAX_S = 16
ROLL_LANES = 16384
CHUNK_LANES = 4096


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
    space: BR.SlotSpace           # kernel B's slots, buckets and tasks
    n_slots: int
    sampled_aggs: int             # aggregates of the sampled classes
    sampled_members: int          # their members
    exact_pairs: int              # sum s_a (s_a - 1) of kernel B's ones


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


def _reference_pairs(space: BR.SlotSpace, v2a, slot, s, r) -> bool:
    """Whether the reference pairs the unit slot tiling of the intra edges
    (s, r) in its own slot layout (the same aggregates and member order on
    bucket bases aligned as plan_bucket aligns them,
    multilevel_tiled.py:112-145): their slab count at the unit shape stays
    within one call (:220-230), so its dispatch takes the bf16-pair gather
    under x_precision='bf16'."""
    shift = np.zeros(space.start.shape[0], dtype=np.int64)
    ref_base = 0
    for b in space.buckets:
        m_b_pad, align = _reference_bucket(b.S, b.m_b)
        ref_base = -(-ref_base // align) * align
        shift[b.aggs.numpy()] = ref_base - b.base
        ref_base += m_b_pad * b.S
    ref = slot + shift[v2a]
    count = ES.slab_count(ref[s], ref[r], -(-ref_base // 128) * 128,
                          UNIT_SENDER_BLOCK, UNIT_WINDOW, UNIT_TILE)
    return count <= ES.MAX_SLABS_PER_CALL


def slot_layout(g: Graph, part: Partition, params: MultilevelFAParams, *,
                ndev: int = 1, shards: range | None = None,
                reference_pairs: bool = False) -> RefineLayout:
    """The layout of one level in kernel B's slot space
    (``BR.slot_space``, over ``shards`` of ``ndev``): the local degrees and
    folded intra-aggregate weights as the reference layout computes them
    (multilevel_tiled.py:199-220), the attraction CSR, the repulsion
    weights.  With ``reference_pairs``, under ``x_precision='bf16'`` a
    unit CSR takes the bf16 gather where the reference's own slot layout
    pairs its tiles; without it the gather never applies.  Only the
    vertices of ``shards`` are laid out, ``slot_of_vertex`` listing theirs
    in increasing id (one process's shards of ``parallel.sharded_ml``).
    Host numpy, tensors on ``g``'s device."""
    dev = g.device
    v2a = part.vertex_to_agg_numpy()
    with timing.span("layout.slots"):
        space = BR.slot_space(v2a, part.num_aggs, ndev=ndev, shards=shards,
                              threshold=params.sampled_slots_threshold)
        n_slots = space.n_slots
        slot_of_vertex = space.slot.numpy() - space.first
        s, r, w = g.to_coo_numpy()
        if shards is not None and len(shards) < ndev:
            # the entries among them, in their order (an intra-aggregate
            # entry has both ends in one aggregate)
            vertices = np.flatnonzero((slot_of_vertex >= 0)
                                      & (slot_of_vertex < n_slots))
            local = np.full(g.n, -1, dtype=np.int64)
            local[vertices] = np.arange(len(vertices))
            keep = (local[s] >= 0) & (local[r] >= 0)
            s, r, w = local[s[keep]], local[r[keep]], np.asarray(w)[keep]
            v2a, slot_of_vertex = v2a[vertices], slot_of_vertex[vertices]
        n = v2a.size
        valid = np.zeros(n_slots, dtype=bool)
        valid[slot_of_vertex] = True

        both = v2a[s] == v2a[r]
        intra = both & (s != r)
        deg_np = np.bincount(
            s[both], weights=(np.asarray(w, np.float64)[both]
                              if params.use_weights else None),
            minlength=n).astype(np.float64)
        folded = F.fold_edge_weights(w, deg_np[s],
                                     use_weights=params.use_weights,
                                     delta=params.delta, nohubs=params.nohubs)
        fw = np.asarray(folded)[intra]
        unit = bool(intra.any()) and bool(np.all(fw == 1.0))
        keep = fw != 0.0
        ss = slot_of_vertex[s[intra][keep]]
        rr = slot_of_vertex[r[intra][keep]]
        paired = False
        if unit and params.x_precision == "bf16" and reference_pairs:
            paired = _reference_pairs(space, v2a, slot_of_vertex, s[intra],
                                      r[intra])
    with timing.span("layout.csr"):
        csr, deg_w = ES.build_csr(ss, rr, None if unit else
                                  ES.truncate_bf16(fw[keep]), n_slots,
                                  device=dev, bf16_gather=paired)

    sampled_aggs = sampled_members = exact_pairs = 0
    for b in space.buckets:
        c = b.counts.numpy()
        if b.sampled:
            sampled_aggs += int(np.count_nonzero(c))
            sampled_members += int(c.sum())
        else:
            exact_pairs += int((c * (c - 1)).sum())
    deg_loc = np.zeros(n_slots, np.float32)
    deg_loc[slot_of_vertex] = deg_np
    w_rep = np.where(valid, deg_loc + 1.0, 0.0).astype(np.float32)
    return RefineLayout(
        slot_of_vertex=torch.from_numpy(slot_of_vertex).to(dev),
        valid_slot=torch.from_numpy(valid).to(dev),
        deg_loc=torch.from_numpy(deg_loc).to(dev),
        w_rep=torch.from_numpy(w_rep).to(dev),
        csr=csr, deg_w=deg_w, sender_csr=sender_csr(g),
        space=space.to(dev), n_slots=n_slots, sampled_aggs=sampled_aggs,
        sampled_members=sampled_members, exact_pairs=exact_pairs)


def prepare_refine(g: Graph, part: Partition,
                   params: MultilevelFAParams) -> RefineLayout:
    """The slot layout of one level on one device (``slot_layout``, one
    bucket per size class), with the reference's bf16 pairing rule."""
    return slot_layout(g, part, params, reference_pairs=True)


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
    per = max(1, BR.PLAIN_MAX_PAIRS // (S * K))
    out = []
    for a0 in range(0, m, per):
        sl = slice(a0, a0 + per)
        acc = BR._pair_sum(x3[sl], ys[sl], w_s[sl],
                           idx[sl, None, :] == own, eps)
        scale = (cnt[sl] / K)[:, None, None]
        out.append(repel * w3[sl, :, None] * acc * scale)
    return torch.cat(out, dim=0)


def bucket_repulsion(x, layout: RefineLayout, repel: float, eps: float, *,
                     num_samples: int = 256,
                     generator: torch.Generator | None = None
                     ) -> torch.Tensor:
    """[n_slots, d] within-aggregate repulsion in slot space: kernel B
    (CUDA) or its plain version (CPU) on the exact buckets, the sampled
    estimator on the rest, with uniforms drawn from ``generator``, one
    [m_c, num_samples] draw per sampled class, smallest first; the
    estimator runs inside the sub-span ``slot.sampled``."""
    space = layout.space
    out = BR.slot_repulsion(x, layout.w_rep, space, repel, eps)
    if not space.sampled_classes:
        return out
    if generator is None:
        raise ValueError("sampled buckets need a generator")
    d = x.shape[1]
    with timing.span("slot.sampled"):
        for m_c, bis in space.sampled_classes:
            u = torch.rand((m_c, num_samples), generator=generator,
                           dtype=x.dtype, device=x.device)
            for bi in bis:
                b = space.buckets[bi]
                ub = u[b.u_row: b.u_row + b.m_b]
                if ub.shape[0] < b.m_b:
                    ub = torch.cat([ub, ub.new_zeros((b.m_b - ub.shape[0],
                                                      num_samples))])
                sl = b.slots
                out[sl] = bucket_repulsion_sampled(
                    x[sl].reshape(b.m_b, b.S, d),
                    layout.w_rep[sl].reshape(b.m_b, b.S), b.counts, ub,
                    repel, eps).reshape(-1, d)
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
    for b in layout.space.buckets:
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
    coordinates before the epilogue.  Counts, on the current logger's
    phase: ``slot_sampled_buckets`` (the sampled classes' aggregates),
    ``slot_sampled_pairs`` (their members times the samples) and
    ``slot_pairs`` (the ordered member pairs kernel B walks), both summed
    over the iterations; all from the layout's host counts."""
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
    timing.count("slot_sampled_buckets", layout.sampled_aggs)
    timing.count("slot_sampled_pairs", layout.sampled_members
                 * params.num_negative_samples * iterations)
    timing.count("slot_pairs", layout.exact_pairs * iterations)
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
