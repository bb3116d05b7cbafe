"""Kernel B's slot view of the portable refinement's member tables
(``forceatlas.multilevel.MemberSlots``): its layout on the CPU, its
replay by kernel B's plain version against the tables' own sum, the
``ml.loop`` counters, and on a CUDA card the kernel path of
``aggregate_repulsion``.  The file imports neither JAX nor the JAX
package, so the GPU host runs it without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_member_slots.py
"""

import numpy as np
import pytest
import torch

import graph_embed_tpu_torch as gp
from graph_embed_tpu_torch import from_edges, interop
from graph_embed_tpu_torch.forceatlas import multilevel as PML
from graph_embed_tpu_torch.forceatlas import multilevel_tiled as MT
from graph_embed_tpu_torch.ops import cuda
from graph_embed_tpu_torch.utils import timing

REPEL, EPS = 1.3, 1e-5
LARGEST = 2927
KINDS = ["mixed", "small", "singletons"]


def _sizes(kind: str) -> np.ndarray:
    """Aggregate sizes of a partition: ``mixed`` holds one-member
    aggregates, the 8 and 16 classes and one of ``LARGEST`` members (its
    table 2,928 wide, no power of two); ``small`` reaches 40 (a 40-wide
    last table); ``singletons`` only one-member aggregates."""
    rng = np.random.default_rng(KINDS.index(kind))
    if kind == "mixed":
        return np.concatenate([np.ones(60, np.int64),
                               rng.integers(2, 9, 50),
                               rng.integers(9, 17, 30), [LARGEST],
                               rng.integers(17, 33, 5)])
    if kind == "small":
        return rng.integers(1, 41, 120)
    return np.ones(300, np.int64)


def _partition(kind: str):
    """(v2a, m) of ``_sizes(kind)``, the vertices dealt at random."""
    sizes = _sizes(kind)
    rng = np.random.default_rng(7)
    v2a = rng.permutation(np.repeat(np.arange(sizes.size), sizes))
    return v2a.astype(np.int32), sizes.size


def _view(kind: str):
    v2a, m = _partition(kind)
    part = interop.partition(v2a, m)
    tables = PML.build_member_buckets(part)
    return v2a, m, tables, PML.member_slots(tables, v2a.size, "cpu")


@pytest.mark.parametrize("kind", KINDS)
def test_every_vertex_has_one_slot(kind):
    """The tables' rows back to back, then one row of 8 ghosts; each
    vertex in exactly one slot, which ``slot`` names."""
    v2a, _, _, view = _view(kind)
    n = v2a.size
    vertex = view.vertex.numpy()
    base = sum(len(t) * w for t, w in zip(view.tables, view.widths))
    assert vertex.size == base + 8 and np.all(vertex[base:] == n)
    members = vertex[vertex < n]
    assert np.array_equal(np.sort(members), np.arange(n))
    assert np.all(vertex[vertex >= n] == n)
    assert np.array_equal(vertex[view.slot.numpy()], np.arange(n))


def test_a_vertex_in_no_table_reads_a_ghost():
    """Tables that leave a vertex out (a row cut to ghosts) send it to the
    closing ghost row."""
    tables = [np.array([[0, 1, 4, 4], [4, 4, 4, 4]], np.int32),
              np.array([[2]], np.int32)]
    view = PML.member_slots(tables, 4, "cpu")
    assert view.widths == (8, 8)
    assert view.slot.tolist() == [0, 1, 16, 24]
    assert view.vertex[24:].tolist() == [4] * 8


@pytest.mark.parametrize("kind", KINDS)
def test_rows_hold_members_before_ghosts(kind):
    """Each row of the view is one table row: its members in the table's
    order, then ghosts."""
    v2a, _, tables, view = _view(kind)
    n = v2a.size
    base = 0
    for t, w in zip(tables, view.widths):
        rows = view.vertex[base: base + t.shape[0] * w].numpy().reshape(-1, w)
        base += t.shape[0] * w
        member = rows < n
        counts = member.sum(axis=1)
        assert np.array_equal(member, np.arange(w) < counts[:, None])
        assert np.array_equal(rows[:, : t.shape[1]], t)
        # every vertex of a row is of one aggregate
        for row, c in zip(rows, counts):
            assert np.unique(v2a[row[:c]]).size <= 1


@pytest.mark.parametrize("kind", KINDS)
def test_view_widths_are_power_of_two_classes(kind):
    """Each table pads to its power-of-two class (>= 8) in the view only;
    the last table of ``mixed`` is 2,928 wide and its class 4,096."""
    _, _, tables, view = _view(kind)
    for t, w, kept in zip(tables, view.widths, view.tables):
        assert w >= max(8, t.shape[1]) and w & (w - 1) == 0
        assert w < 2 * max(t.shape[1], 8)
        assert tuple(kept.shape) == t.shape
    if kind == "mixed":
        assert (tables[-1].shape[1], view.widths[-1]) == (2928, 4096)


def _partners(tasks: np.ndarray, aggs: np.ndarray) -> int:
    """Sum over kernel B's member rows of their partners (the self pair
    not counted), decoded from the task table as the kernel walks it."""
    total = 0
    for p, S, r0, w in tasks.tolist():
        if S < 0:
            continue                      # zeros: no partner loop
        if S > cuda.BUCKET_TILE:
            total += max(0, min(cuda.BUCKET_TILE, w - r0)) * (w - 1)
            continue
        k, r = p, r0
        for _ in range(w):
            c = int(aggs[k, 1])
            total += c - 1
            r += 1
            if r == c:
                k, r = k + 1, 0
    return total


@pytest.mark.parametrize("kind", KINDS)
def test_task_partners_sum_to_the_layout_pairs(kind):
    """The task table's partner counts sum to ``MultilevelLayout.pairs``,
    the ordered member pairs: kernel B computes no padded pair."""
    v2a, m, _, _ = _view(kind)
    n = v2a.size
    rng = np.random.default_rng(3)
    s, r = rng.integers(0, n, 4 * n), rng.integers(0, n, 4 * n)
    keep = s != r
    g = from_edges(s[keep], r[keep], None, n=n, symmetrize=True)
    layout = PML.prepare_multilevel(g, interop.partition(v2a, m),
                                    gp.MultilevelFAParams())
    view = PML.member_slots(layout.members, n, "cpu")
    assert _partners(view.tasks.numpy(), view.aggs.numpy()) == layout.pairs


@pytest.mark.parametrize("kind", KINDS)
def test_cpu_layouts_keep_the_plain_tables(kind):
    """Off the card no slot view is built: ``prepare_multilevel`` and
    ``farfield.Groups.build`` hold the member tables as int64 tensors,
    bit for bit ``build_member_buckets``'s."""
    from graph_embed_tpu_torch.forceatlas import farfield

    v2a, m, tables, _ = _view(kind)
    n = v2a.size
    part = interop.partition(v2a, m)
    g = from_edges(np.arange(n - 1), np.arange(1, n), None, n=n,
                   symmetrize=True)
    layout = PML.prepare_multilevel(g, part, gp.MultilevelFAParams())
    groups = farfield.Groups.build(part, "cpu")
    for members in (layout.members, groups.members):
        assert isinstance(members, tuple)
        assert len(members) == len(tables)
        for got, want in zip(members, tables):
            assert got.dtype == torch.int64
            assert torch.equal(got, torch.from_numpy(want).long())


@pytest.mark.parametrize("kind", KINDS)
def test_slot_replay_equals_the_tables_sum(kind):
    """Kernel B's plain version over the slot view, gathered back by each
    vertex's slot, is ``aggregate_repulsion(..., exact=True)`` over
    the tables in float64, within 1e-12 of each element's sum of
    |terms|."""
    v2a, _, tables, view = _view(kind)
    n = v2a.size
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.uniform(-1, 1, (n, 3)))
    w = torch.from_numpy(rng.uniform(1, 4, n))
    xs = torch.cat([x, x.new_zeros((1, 3))])[view.vertex]
    ws = torch.cat([w, w.new_zeros(1)])[view.vertex]
    slots = torch.zeros_like(xs)
    base = 0
    for t, width in zip(tables, view.widths):
        sl = slice(base, base + t.shape[0] * width)
        base = sl.stop
        slots[sl] = MT.bucket_repulsion_plain(
            xs[sl].reshape(-1, width, 3), ws[sl].reshape(-1, width), REPEL,
            EPS).reshape(-1, 3)
    got = slots[view.slot]
    want = PML.aggregate_repulsion(x, tables, w, REPEL, EPS, exact=True)
    scale = PML.aggregate_repulsion(x, tables, w, REPEL, EPS, exact=True,
                                    absolute=True)
    assert not slots[view.vertex == n].any()
    assert bool(((got - want).abs() <= 1e-12 * scale).all())


def test_members_must_come_first():
    """A row with a ghost before a member is no kernel B layout."""
    with pytest.raises(ValueError, match="members first"):
        PML.member_slots([np.array([[0, 3, 1, 3]], np.int32)], 3, "cpu")


def _level(rng, kind: str, device):
    v2a, m = _partition(kind)
    n = v2a.size
    s, r = rng.integers(0, n, 3 * n), rng.integers(0, n, 3 * n)
    keep = s != r
    g = from_edges(s[keep], r[keep], rng.uniform(0.5, 2.0, keep.sum()), n=n,
                   symmetrize=True, device=device)
    part = interop.partition(v2a, m).to(device)
    cA = torch.from_numpy(rng.uniform(-5, 5, (m, 3)).astype(np.float32)).to(
        device)
    return g, part, cA, torch.full((m,), 0.25, device=device)


def _traced_refine(g, part, cA, rA, iterations, device):
    """``force_atlas_multilevel`` inside a phase of a logger: its
    ``ml.loop`` sub-span."""
    metrics = gp.MetricsLogger()
    with timing.use(metrics), metrics.span("refine", device):
        gp.force_atlas_multilevel(g, part, cA, rA, 3, seed=1,
                                  iterations=iterations, device=device)
    loop, = [s for s in metrics.records[0]["sub"] if s["name"] == "ml.loop"]
    return loop


def test_ml_loop_counts_on_the_cpu():
    """On the CPU ``ml.loop`` counts no kernel B launch, and its pair
    counters are the tables' hand counts."""
    g, part, cA, rA = _level(np.random.default_rng(5), "small", "cpu")
    loop = _traced_refine(g, part, cA, rA, 3, "cpu")
    sizes = np.bincount(part.vertex_to_agg_numpy(), minlength=part.num_aggs)
    tables = PML.build_member_buckets(part)
    assert loop["counts"] == {
        "ml_pairs": int((sizes * (sizes - 1)).sum()),
        "ml_padded_pairs": sum(t.shape[0] * t.shape[1] ** 2 for t in tables),
        "ml_largest_aggregate": int(sizes.max())}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("repulsion", ["gram", "exact"])
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_path_within_rounding_of_float64(dev, kind, repulsion):
    """Kernel B on the card against the float64 sum of the same float32
    inputs, for both repulsion names: each element within 256 x 2^-24 of
    its sum of |terms|; one launch, repeatable bitwise, and the prepared
    view and the plain tables give the same bits."""
    v2a, _, tables, _ = _view(kind)
    n = v2a.size
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.uniform(-1, 1, (n, 3)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(1, 4, n).astype(np.float32))
    x64, w64 = x.double(), w.double()
    want = PML.aggregate_repulsion(x64, tables, w64, REPEL, EPS, exact=True)
    scale = PML.aggregate_repulsion(x64, tables, w64, REPEL, EPS, exact=True,
                                    absolute=True)
    view = PML.member_slots(tables, n, dev)
    xd, wd = x.to(dev), w.to(dev)
    exact = repulsion == "exact"
    before = cuda.LAUNCHES["bucket_repulsion"]
    got = PML.aggregate_repulsion(xd, view, wd, REPEL, EPS, exact=exact)
    assert cuda.LAUNCHES["bucket_repulsion"] == before + 1
    err = (got.cpu().double() - want).abs()
    assert bool((err <= 256 * 2.0**-24 * scale).all()), float(err.max())
    assert torch.equal(PML.aggregate_repulsion(xd, view, wd, REPEL, EPS,
                                               exact=exact), got)
    assert torch.equal(PML.aggregate_repulsion(xd, tables, wd, REPEL, EPS,
                                               exact=exact), got)


@pytest.mark.cuda
def test_kernel_path_raises_for_what_it_does_not_take(dev):
    """No fallback: float64 on the card, and the rounding scales, raise."""
    v2a, _, tables, _ = _view("small")
    n = v2a.size
    view = PML.member_slots(tables, n, dev)
    x = torch.rand((n, 3), device=dev, dtype=torch.float64)
    w = torch.ones(n, device=dev, dtype=torch.float64)
    with pytest.raises(ValueError):
        PML.aggregate_repulsion(x, view, w, REPEL, EPS)
    with pytest.raises(ValueError):
        PML.aggregate_repulsion(x.float(), view, w.float(), REPEL, EPS,
                                absolute=True)


@pytest.mark.cuda
def test_ml_loop_counts_one_launch_per_iteration(dev):
    """On the card ``ml.loop`` counts one kernel B launch per iteration,
    and ``cuda.LAUNCHES`` grows by as many."""
    g, part, cA, rA = _level(np.random.default_rng(5), "mixed", dev)
    before = cuda.LAUNCHES["bucket_repulsion"]
    loop = _traced_refine(g, part, cA, rA, 7, dev)
    assert loop["counts"]["ml_repulsion_launches"] == 7
    assert cuda.LAUNCHES["bucket_repulsion"] - before == 7
