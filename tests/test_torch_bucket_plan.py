"""Kernel B's task table (``ops.bucket_repulsion._task_table``) and the
schedule of its warps, on the CPU.

Kernel B (csrc/bucket_repulsion.cu) runs members against members only:
each aggregate holds its members first and ghosts after, so a ghost
partner adds fmaf(+0, diff, acc), which leaves the sum as it is, and a
ghost row writes a zero.  ``task_schedule`` below restates what a warp
does with each row of the table, so the properties the kernel relies on
can be checked without the card: every slot of every exact bucket written
once, sampled buckets untouched, each member slot's partners the members
of its aggregate in ascending order (itself among them, as a zero term).
A sequential restatement of the kernel's arithmetic shows that dropping
the ghost partners keeps every sum, and both are held to the plain
version.
"""

import numpy as np
import pytest
import torch

from graph_embed_tpu_torch import from_edges
from graph_embed_tpu_torch.forceatlas import multilevel_tiled as MT
from graph_embed_tpu_torch.ops import bucket_repulsion as BR
from graph_embed_tpu_torch.ops import cuda
from graph_embed_tpu_torch.parallel import sharded_ml as SML
from graph_embed_tpu_torch.partition.interpolation import Partition
from graph_embed_tpu_torch.utils.params import MultilevelFAParams

T = cuda.BUCKET_TILE   # csrc/bucket_repulsion.cu: WARP_SLOTS
# member counts that leave partial aggregates in every class 8..1024
COUNTS = [1, 5, 8, 8, 9, 12, 16, 17, 30, 32, 33, 64, 65, 100, 128, 129,
          256, 300, 512, 513, 1000, 1024]


def task_schedule(table, aggs):
    """What each lane of each warp task does: [(slot, partners)], where
    ``partners`` lists the slots a member row adds, in order, and is None
    for a slot written 0."""
    out = []
    for first, S, z, w in table.tolist():
        if S < 0:                       # zeros: the masked slots
            out += [(first + lane, None) for lane in range(z)
                    if (w >> lane) & 1]
        elif S <= T:                    # rows of aggs[first], aggs[first+1]..
            k, r = first, z
            for _ in range(w):
                a0, c = aggs[k]
                out.append((a0 + r, [a0 + j for j in range(c)]))
                r += 1
                if r == c:
                    k, r = k + 1, 0
        else:                           # rows z.. of the aggregate at first
            for row in range(z, min(z + T, S)):
                partners = [first + j for j in range(w)] if row < w else None
                out.append((first + row, partners))
    return out


def task_cost(table, aggs):
    """Each task's partner count, the one its longest row loops (0 for a
    task that only writes zeros)."""
    first, S, z, w = table.T
    small = aggs[np.clip(first, 0, len(aggs) - 1), 1] if len(aggs) else 0
    return np.where(S < 0, 0, np.where(S <= T, small,
                                       np.where(z < w, w, 0)))


def _graph_and_part(rng, counts, n_extra_aggs=0):
    counts = np.asarray(counts)
    v2a = np.repeat(np.arange(counts.size), counts)
    v2a = rng.permutation(v2a)
    n = v2a.size
    s = rng.integers(0, n, 3 * n)
    r = rng.integers(0, n, 3 * n)
    keep = s != r
    g = from_edges(s[keep], r[keep], None, n=n, symmetrize=True)
    return g, Partition.from_numpy(v2a, counts.size + n_extra_aggs)


def _layouts(rng):
    g, part = _graph_and_part(rng, COUNTS)
    yield "exact", MT.prepare_refine(
        g, part, MultilevelFAParams(sampled_slots_threshold=0))
    yield "sampled from 512", MT.prepare_refine(
        g, part, MultilevelFAParams(sampled_slots_threshold=512))
    yield "3 shards", SML.prepare_refine_sharded(
        g, part, MultilevelFAParams(sampled_slots_threshold=0), 3).layout


def test_schedule_covers_exact_slots_once_members_in_order(rng):
    """Every slot of every exact bucket written once, sampled buckets left
    alone; a slot is a member row exactly when it is valid (in the small
    classes, and its aggregate has another member), and its partners are
    the members of its aggregate, ascending, itself included; the table
    runs the longest tasks first."""
    for name, layout in _layouts(rng):
        table = layout.space.tasks.numpy()
        aggs = layout.space.aggs.numpy()
        valid = layout.valid_slot.numpy()
        seen = np.zeros(layout.n_slots, np.int64)
        for slot, partners in task_schedule(table, aggs):
            seen[slot] += 1
            if partners is None:
                continue
            assert valid[slot], name
            b = next(b for b in layout.space.buckets
                     if b.slots.start <= slot < b.slots.stop)
            a = b.base + (slot - b.base) // b.S * b.S
            want = [j for j in range(a, a + b.S) if valid[j]]
            assert partners == want and slot in partners, name
            assert len(want) >= 2 or b.S > T, name   # lone members: zeros
        for b in layout.space.buckets:
            assert np.all(seen[b.slots] == (0 if b.sampled else 1)), name
        assert any(b.sampled for b in layout.space.buckets) == (
            name == "sampled from 512")
        cost = task_cost(table, aggs)
        assert np.all(cost[:-1] >= cost[1:]), name


def test_table_rows_are_cut_in_warp_steps(rng):
    """Small classes: rows tasks of T member rows (fewer only at a class's
    end) over the class's aggregates of 2+ members, by count, largest
    first; zeros tasks of T slots from the bucket's base.  Larger classes:
    T rows of one aggregate per task."""
    _, layout = next(_layouts(rng))
    table = layout.space.tasks.numpy()
    aggs = layout.space.aggs.numpy()
    valid = layout.valid_slot.numpy()
    for b in layout.space.buckets:
        counts = valid[b.slots].reshape(b.m_b, b.S).sum(axis=1)
        if b.S <= T:
            rows = table[table[:, 1] == b.S]
            paired = counts[counts >= 2]
            first = rows[:, 0].min() if rows.size else 0
            mine = aggs[first: first + paired.size]
            assert mine[:, 1].tolist() == sorted(paired, reverse=True)
            assert rows[:, 3].sum() == paired.sum()
            assert np.all(rows[:, 3] <= T)
            zeros = table[table[:, 1] == -b.S]
            assert np.all((zeros[:, 0] - b.base) % T == 0)
            assert np.all(zeros[:, 3] != 0)
        else:
            rows = table[table[:, 1] == b.S]
            assert rows.shape[0] == b.m_b * (b.S // T)
            assert set(rows[:, 2]) == set(range(0, b.S, T))


def test_table_refuses_ghosts_before_members():
    b = BR.Bucket(base=0, m_b=1, S=8, aggs=torch.zeros(1, dtype=torch.long),
                  counts=torch.tensor([2]), sampled=False)
    valid = np.array([True, False, True] + [False] * 5)
    with pytest.raises(ValueError, match="members first"):
        BR._task_table([b], valid)
    b = BR.Bucket(base=0, m_b=1, S=4, aggs=torch.zeros(1, dtype=torch.long),
                  counts=torch.tensor([2]), sampled=False)
    with pytest.raises(ValueError, match=">= 8"):
        BR._task_table([b], np.array([True, True, False, False]))


def _sequential(x3, w3, counts, repel, eps, members_only):
    """Kernel B's arithmetic in its order, one partner after another: over
    every slot of the aggregate (ghost partners with weight 0), or over
    its members only; ghost rows 0 in the second."""
    m, S, d = x3.shape
    acc = torch.zeros_like(x3)
    rows = torch.arange(S)
    for j in range(S):
        diff = x3 - x3[:, j: j + 1, :]
        d2 = diff[..., 0] * diff[..., 0]
        for k in range(1, d):
            d2 = d2 + diff[..., k] * diff[..., k]
        dist = torch.clamp(torch.sqrt(d2), min=eps)
        W = w3[:, j: j + 1] / (dist * dist * dist)
        W = torch.where(rows[None, :] == j, torch.zeros_like(W), W)
        term = acc + W[..., None] * diff
        if members_only:
            term = torch.where((j < counts)[:, None, None], term, acc)
        acc = term
    out = repel * w3[..., None] * acc
    if members_only:
        member = rows[None, :] < counts[:, None]
        out = torch.where(member[..., None], out, torch.zeros_like(out))
    return out


@pytest.mark.parametrize("S", [8, 16, 32, 64, 128, 256, 512, 1024])
def test_members_only_keeps_every_sum(rng, S):
    """Aggregates of 1, S / 2 + 1 and S members: the member-only sums equal
    the all-slot sums (torch.equal; a ghost row's zero may differ in sign
    only), and both lie within 1e-5 of each element's sum of |terms| of
    ``bucket_repulsion_plain``."""
    counts = torch.tensor([1, S // 2 + 1, S])
    m, d = counts.numel(), 3
    member = torch.arange(S)[None, :] < counts[:, None]
    x3 = torch.from_numpy(rng.uniform(-1, 1, (m, S, d)).astype(np.float32))
    x3 = torch.where(member[..., None], x3, torch.zeros_like(x3))
    w3 = torch.from_numpy(rng.uniform(1, 6, (m, S)).astype(np.float32))
    w3 = torch.where(member, w3, torch.zeros_like(w3))
    x3[1, 1] = x3[1, 0]   # a coincident pair: d clamps at eps
    repel, eps = 1.3, 1e-5
    every = _sequential(x3, w3, counts, repel, eps, members_only=False)
    mine = _sequential(x3, w3, counts, repel, eps, members_only=True)
    assert torch.equal(mine, every)
    assert not mine[~member].any()
    want = BR.bucket_repulsion_plain(x3, w3, repel, eps)
    scale = BR.bucket_repulsion_plain(x3, w3, repel, eps, absolute=True)
    assert torch.all((mine - want).abs() <= 1e-5 * scale)
