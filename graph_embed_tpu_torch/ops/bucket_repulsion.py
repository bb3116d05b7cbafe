"""Within-aggregate repulsion: kernel B (``csrc/bucket_repulsion.cu``)
and the slot space it runs over.

In slot space each aggregate takes a power-of-two size class S (>= 8),
the classes lie back to back, smallest first and ids ascending in each,
and an aggregate holds S consecutive slots, its members first in
increasing vertex id and ghosts after.  ``slot_space`` builds it, dealt
over shards when asked, with kernel B's warp tasks; every refinement that
runs kernel B takes its slots from there.  Kernel B writes, per member
slot i, repel * w_i * sum_{j != i} w_j (x_i - x_j) / max(d_ij, eps)^3
over the members j of its aggregate (difference-form d^2), and 0 to a
ghost.  ``slot_repulsion`` launches it on a CUDA tensor and runs the plain
PyTorch version on a CPU tensor; there is no fallback between the two.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import cuda

# the plain versions evaluate at most this many pairs at once
PLAIN_MAX_PAIRS = 1 << 24


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
class SlotSpace:
    """Kernel B's slot space of one level (``slot_space``): the shards'
    spaces, each holding the same classes, stacked device major; it spans
    ``shards``, whose first slot in that stack is ``first``.  ``start``
    [m] and ``slot`` [n]: each aggregate's and each vertex's first slot in
    the stack; ``vertex`` [n_slots]: the vertex in each slot of ``shards``
    (n on a ghost); ``buckets``: one per (shard, class), shard major,
    bases from ``first``; ``sampled_classes``: per sampled class, smallest
    first, (its aggregates, its buckets' indices): its uniforms are drawn
    at once and dealt m_b rows per bucket from ``Bucket.u_row`` (ghost
    aggregates get zeros), so a dealt class draws as one bucket does;
    ``tasks``, ``aggs``: kernel B's int32 tables (``_task_table``)."""

    start: torch.Tensor
    slot: torch.Tensor
    vertex: torch.Tensor
    buckets: tuple
    sampled_classes: tuple
    tasks: torch.Tensor
    aggs: torch.Tensor
    first: int

    @property
    def n_slots(self) -> int:
        return self.vertex.shape[0]

    def to(self, device) -> "SlotSpace":
        moved = {k: getattr(self, k).to(device)
                 for k in ("start", "slot", "vertex", "tasks", "aggs")}
        return dataclasses.replace(self, **moved, buckets=tuple(
            dataclasses.replace(b, aggs=b.aggs.to(device),
                                counts=b.counts.to(device))
            for b in self.buckets))


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


def slot_space(v2a, num_aggs: int, *, ndev: int = 1,
               shards: range | None = None,
               threshold: int = 0) -> SlotSpace:
    """Kernel B's slot space of the aggregates ``v2a`` (host [n], ids below
    ``num_aggs``), as CPU tensors (``SlotSpace.to`` places them).  Each
    class is dealt over ``ndev`` shards: aggregate k of a class of m_c goes
    to shard k // q at rank k % q, q = ceil(m_c / ndev) (ghost aggregates,
    id ``num_aggs`` and count 0, where a shard runs out); the space spans
    ``shards`` (every shard by default).  One shard is the single-device
    layout.  Classes of ``threshold`` slots or more (0: none) are sampled
    and take no task."""
    v2a = np.asarray(v2a)
    m, n = num_aggs, v2a.size
    shards = range(ndev) if shards is None else shards
    counts = np.bincount(v2a, minlength=m)
    classes = size_classes(counts)
    qs = [-(-aggs.size // ndev) for _, aggs in classes]
    nsl = sum(q * S for (S, _), q in zip(classes, qs))
    first = shards.start * nsl

    start = np.zeros(m, dtype=np.int64)
    buckets = []
    for d in range(ndev):
        base = d * nsl
        for (S, aggs), q in zip(classes, qs):
            ids = aggs[d * q: (d + 1) * q]
            start[ids] = base + np.arange(ids.size) * S
            if d in shards:
                padded = np.concatenate([ids, np.full(q - ids.size, m)])
                buckets.append(Bucket(
                    base=int(base - first), m_b=q, S=S,
                    aggs=torch.from_numpy(padded),
                    counts=torch.from_numpy(np.append(counts, 0)[padded]),
                    sampled=threshold > 0 and S >= threshold, u_row=d * q))
            base += q * S
    slot = vertex_slots(v2a, counts, start)
    vertex = np.full(len(shards) * nsl, n, dtype=np.int64)
    mine = (slot >= first) & (slot < first + vertex.size)
    vertex[slot[mine] - first] = np.flatnonzero(mine)
    tasks, task_aggs = _task_table(buckets, vertex < n)
    return SlotSpace(
        start=torch.from_numpy(start), slot=torch.from_numpy(slot),
        vertex=torch.from_numpy(vertex), buckets=tuple(buckets),
        sampled_classes=tuple(
            (aggs.size, tuple(i for i, b in enumerate(buckets)
                              if b.sampled and b.S == S))
            for S, aggs in classes if threshold > 0 and S >= threshold),
        tasks=torch.from_numpy(tasks), aggs=torch.from_numpy(task_aggs),
        first=first)


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

    x3: [m, S, d] slot coordinates; w3: [m, S] weights (0 on ghosts).
    Returns repel * w_i * sum_{j != i} w_j (x_i - x_j) / max(d_ij, eps)^3
    per slot, [m, S, d]; diff-form d^2.  ``absolute`` sums the terms'
    magnitudes instead (see ``slot_repulsion_plain``)."""
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


def slot_repulsion_plain(x, w, space: SlotSpace, repel: float, eps: float,
                         *, absolute: bool = False) -> torch.Tensor:
    """Plain version of kernel B over every exact bucket of ``space``, on
    slot coordinates ``x`` [n_slots, d] with weights ``w`` [n_slots];
    slots of sampled buckets are left at zero.

    With ``absolute`` each slot gets repel * w_i * sum_j |term_ij| per axis
    instead: the size of the float32 rounding in that slot's sum, the
    scale against which kernel B is held to this version element by
    element."""
    d = x.shape[1]
    out = torch.zeros_like(x)
    for b in space.buckets:
        if b.sampled:
            continue
        sl = b.slots
        out[sl] = bucket_repulsion_plain(
            x[sl].reshape(b.m_b, b.S, d), w[sl].reshape(b.m_b, b.S),
            repel, eps, absolute=absolute).reshape(-1, d)
    return out


def slot_repulsion_cuda(x, w, space: SlotSpace, repel: float,
                        eps: float) -> torch.Tensor:
    """Kernel B: one launch over ``space``'s warp tasks, on slot
    coordinates ``x`` [n_slots, d] with weights ``w`` [n_slots] (0 on
    ghosts): members against members, ghost slots written 0.  Slots of
    sampled buckets are left unwritten (the caller fills them)."""
    tasks, aggs = space.tasks, space.aggs
    if not x.is_cuda or any(t.device != x.device for t in (w, tasks, aggs)):
        raise ValueError("kernel B needs x and the slot space on one CUDA "
                         "device")
    if (x.dtype != torch.float32 or not x.is_contiguous() or x.dim() != 2
            or x.shape[0] != space.n_slots or not 1 <= x.shape[1] <= 4):
        raise ValueError(f"kernel B takes contiguous float32 "
                         f"[{space.n_slots}, d<=4] slot coordinates, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if (w.dtype != torch.float32 or not w.is_contiguous()
            or tuple(w.shape) != (x.shape[0],)):
        raise ValueError(f"kernel B takes contiguous float32 "
                         f"[{x.shape[0]}] slot weights, got {w.dtype} "
                         f"{tuple(w.shape)}")
    if (tasks.dtype != torch.int32 or not tasks.is_contiguous()
            or tasks.data_ptr() % 16 != 0 or aggs.dtype != torch.int32
            or not aggs.is_contiguous() or aggs.data_ptr() % 8 != 0):
        raise ValueError("kernel B's task table and aggregates must be "
                         "aligned int32")
    out = torch.empty_like(x)
    if tasks.shape[0] == 0:
        return out
    with torch.cuda.device(x.device):
        rc = cuda.library().ge_bucket_repulsion(
            tasks.shape[0], x.shape[1], tasks.data_ptr(), aggs.data_ptr(),
            aggs.shape[0], x.data_ptr(), w.data_ptr(), out.data_ptr(),
            float(repel), float(eps), cuda.stream_of(x))
    cuda.check(rc, "bucket_repulsion")
    cuda.LAUNCHES["bucket_repulsion"] += 1
    return out


def slot_repulsion(x, w, space: SlotSpace, repel: float,
                   eps: float) -> torch.Tensor:
    """Kernel B over ``space``'s exact buckets: the launch for a CUDA
    tensor, the plain version for a CPU tensor.  Slots of sampled buckets
    are the caller's."""
    if x.is_cuda:
        return slot_repulsion_cuda(x, w, space, repel, eps)
    if x.device.type != "cpu":
        raise ValueError(f"kernel B runs on CUDA or the CPU, not "
                         f"{x.device}")
    return slot_repulsion_plain(x, w, space, repel, eps)


def vertex_repulsion(x, w, space: SlotSpace, repel: float,
                     eps: float) -> torch.Tensor:
    """Kernel B on [n, d] vertex coordinates ``x`` with weights ``w`` [n]:
    both gathered into ``space``'s slots (a ghost weighs 0, and kernel B
    reads no ghost's coordinates), ``slot_repulsion``, and the result
    gathered back by each vertex's slot."""
    n = x.shape[0]
    src = torch.clamp(space.vertex, max=n - 1)
    f = slot_repulsion(x.index_select(0, src),
                       torch.where(space.vertex < n, w.index_select(0, src),
                                   0.0), space, repel, eps)
    return f.index_select(0, space.slot)
