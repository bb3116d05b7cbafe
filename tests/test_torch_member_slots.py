"""Kernel B's slot space (``ops.bucket_repulsion.slot_space``) as each of
its callers builds it: the slot refinement (``prepare_refine``), the
portable refinement (``prepare_multilevel`` on a card, through
``repulsion_members``) and the sharded refinement
(``prepare_refine_sharded`` on 1 and 3 shards).  Its layout on the CPU,
its replay by kernel B's plain version against the member tables' own
sum, the ``ml.loop`` counters, and on a CUDA card the kernel path of
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
from graph_embed_tpu_torch.ops import bucket_repulsion as BR
from graph_embed_tpu_torch.ops import cuda
from graph_embed_tpu_torch.parallel import sharded_ml as SML
from graph_embed_tpu_torch.utils import timing

REPEL, EPS = 1.3, 1e-5
LARGEST = 2927
KINDS = ["mixed", "small", "singletons"]
CALLERS = ["prepare_refine", "prepare_multilevel", "sharded1", "sharded3"]


def _sizes(kind: str) -> np.ndarray:
    """Aggregate sizes of a partition: ``mixed`` holds one-member
    aggregates, the 8 and 16 classes and one of ``LARGEST`` members (its
    table 2,928 wide, no power of two; its class 4,096); ``small`` reaches
    40 (a 40-wide last table); ``singletons`` only one-member
    aggregates."""
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


def _space(caller: str, kind: str, monkeypatch):
    """(v2a, m, tables, the slot space ``caller`` builds for kernel B)
    of ``_partition(kind)``, on the CPU.  ``prepare_multilevel`` builds its
    space only for a card (``repulsion_members``); here it stays on the
    host, where the card's is placed from."""
    v2a, m = _partition(kind)
    n = v2a.size
    part = interop.partition(v2a, m)
    g = from_edges(np.arange(n - 1), np.arange(1, n), None, n=n,
                   symmetrize=True)
    params = gp.MultilevelFAParams(sampled_slots_threshold=0)
    if caller == "prepare_refine":
        space = MT.prepare_refine(g, part, params).space
    elif caller == "prepare_multilevel":
        monkeypatch.setattr(BR.SlotSpace, "to", lambda self, device: self)
        space = PML.repulsion_members(part, "cuda")
    else:
        space = SML.prepare_refine_sharded(
            g, part, params, int(caller[-1])).layout.space
    return v2a, m, PML.build_member_buckets(part), space


def _rows(space):
    """Each bucket's slots as [m_b, S] vertex rows, with its aggregate
    ids."""
    vertex = space.vertex.numpy()
    for b in space.buckets:
        yield b, vertex[b.slots].reshape(b.m_b, b.S), b.aggs.numpy()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("caller", CALLERS)
def test_every_vertex_has_one_slot(caller, kind, monkeypatch):
    """The buckets back to back, no slot outside them; each vertex in
    exactly one slot, which ``slot`` names, at its aggregate's ``start``
    plus its rank among the members."""
    v2a, m, _, space = _space(caller, kind, monkeypatch)
    n = v2a.size
    vertex = space.vertex.numpy()
    assert vertex.size == sum(b.m_b * b.S for b in space.buckets)
    assert np.array_equal(np.sort(vertex[vertex < n]), np.arange(n))
    assert np.all(vertex[vertex >= n] == n)
    slot = space.slot.numpy()
    assert np.array_equal(vertex[slot], np.arange(n))
    start = space.start.numpy()
    assert np.all(slot >= start[v2a])
    assert np.all(slot < start[v2a] + np.bincount(v2a, minlength=m)[v2a])


def test_a_vertex_in_no_table_reads_a_ghost():
    """Tables that leave a vertex out (a row cut to ghosts): the vertex
    becomes an aggregate of its own and gets force 0, as on the CPU path;
    each row is an aggregate, members first."""
    tables = [np.array([[0, 1, 4, 4], [4, 4, 4, 4]], np.int32),
              np.array([[2]], np.int32)]
    space = PML._table_space(tables, 4)
    assert [b.S for b in space.buckets] == [8]
    assert space.slot.tolist() == [0, 1, 16, 24]
    assert space.vertex[24:].tolist() == [3] + [4] * 7
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.uniform(-1, 1, (4, 3)))
    w = torch.from_numpy(rng.uniform(1, 4, 4))
    got = PML.aggregate_repulsion(x, space, w, REPEL, EPS)
    want = PML.aggregate_repulsion(x, tables, w, REPEL, EPS, exact=True)
    assert not got[2:].any() and not want[2:].any()
    assert torch.allclose(got, want, rtol=1e-12, atol=0)
    assert got[0].abs().min() > 0


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("caller", CALLERS)
def test_rows_hold_members_before_ghosts(caller, kind, monkeypatch):
    """Each row of a bucket is one aggregate: its members in increasing
    vertex id, then ghosts; a ghost aggregate's row is all ghosts."""
    v2a, m, _, space = _space(caller, kind, monkeypatch)
    n = v2a.size
    members = [np.flatnonzero(v2a == a) for a in range(m)]
    for b, rows, aggs in _rows(space):
        for row, a in zip(rows, aggs):
            want = members[a] if a < m else np.zeros(0, np.int64)
            assert np.array_equal(row[: want.size], want)
            assert np.all(row[want.size:] == n)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("caller", CALLERS)
def test_view_widths_are_power_of_two_classes(caller, kind, monkeypatch):
    """Every bucket is a power-of-two class (>= 8) that its aggregates need
    and no smaller one would hold; on one shard the classes are the member
    tables', each table padded to its class (the last table of ``mixed``
    is 2,928 wide and its class 4,096)."""
    v2a, m, tables, space = _space(caller, kind, monkeypatch)
    counts = np.append(np.bincount(v2a, minlength=m), 0)
    for b, _, aggs in _rows(space):
        c = counts[aggs]
        assert b.S >= 8 and b.S & (b.S - 1) == 0
        assert np.all(c <= b.S) and np.all(2 * np.maximum(c[c > 0], 8) > b.S)
        assert np.array_equal(b.counts.numpy(), c)
    widths = sorted({b.S for b in space.buckets})
    assert widths == [max(8, 1 << (t.shape[1] - 1).bit_length())
                      for t in tables]
    if caller != "sharded3":
        assert [b.m_b for b in space.buckets] == [len(t) for t in tables]
    if kind == "mixed":
        assert (tables[-1].shape[1], widths[-1]) == (2928, 4096)


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
@pytest.mark.parametrize("caller", CALLERS)
def test_task_partners_sum_to_the_layout_pairs(caller, kind, monkeypatch):
    """The task table's partner counts sum to ``MultilevelLayout.pairs``,
    the ordered member pairs: kernel B computes no padded pair."""
    v2a, m, _, space = _space(caller, kind, monkeypatch)
    n = v2a.size
    rng = np.random.default_rng(3)
    s, r = rng.integers(0, n, 4 * n), rng.integers(0, n, 4 * n)
    keep = s != r
    g = from_edges(s[keep], r[keep], None, n=n, symmetrize=True)
    layout = PML.prepare_multilevel(g, interop.partition(v2a, m),
                                    gp.MultilevelFAParams())
    assert _partners(space.tasks.numpy(), space.aggs.numpy()) == layout.pairs


@pytest.mark.parametrize("kind", KINDS)
def test_portable_and_slot_layouts_share_one_slot_space(kind, monkeypatch):
    """A level's portable layout (as a card builds it) and its slot layout
    give kernel B the same slot space: every slot, task and bucket."""
    _, _, _, portable = _space("prepare_multilevel", kind, monkeypatch)
    _, _, _, tiled = _space("prepare_refine", kind, monkeypatch)
    for name in ("start", "slot", "vertex", "tasks", "aggs"):
        assert torch.equal(getattr(portable, name), getattr(tiled, name))
    assert portable.first == tiled.first == 0
    assert portable.sampled_classes == tiled.sampled_classes == ()
    assert len(portable.buckets) == len(tiled.buckets)
    for a, b in zip(portable.buckets, tiled.buckets):
        assert (a.base, a.m_b, a.S, a.sampled) == (b.base, b.m_b, b.S,
                                                   b.sampled)
        assert torch.equal(a.aggs, b.aggs)
        assert torch.equal(a.counts, b.counts)


@pytest.mark.parametrize("kind", KINDS)
def test_cpu_layouts_keep_the_plain_tables(kind):
    """Off the card no slot space is built: ``prepare_multilevel`` and
    ``farfield.Groups.build`` hold the member tables as int64 tensors,
    bit for bit ``build_member_buckets``'s."""
    from graph_embed_tpu_torch.forceatlas import farfield

    v2a, m = _partition(kind)
    n = v2a.size
    part = interop.partition(v2a, m)
    tables = PML.build_member_buckets(part)
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
@pytest.mark.parametrize("caller", CALLERS)
def test_slot_replay_equals_the_tables_sum(caller, kind, monkeypatch):
    """Kernel B's plain version over the slot space, gathered back by each
    vertex's slot (``vertex_repulsion`` on CPU tensors), is
    ``aggregate_repulsion(..., exact=True)`` over the tables in float64,
    within 1e-12 of each element's sum of |terms|; ghost slots get 0."""
    v2a, _, tables, space = _space(caller, kind, monkeypatch)
    n = v2a.size
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.uniform(-1, 1, (n, 3)))
    w = torch.from_numpy(rng.uniform(1, 4, n))
    got = BR.vertex_repulsion(x, w, space, REPEL, EPS)
    src = torch.clamp(space.vertex, max=n - 1)
    slots = BR.slot_repulsion(x[src], torch.where(space.vertex < n, w[src],
                                                  0.0), space, REPEL, EPS)
    assert torch.equal(slots[space.slot], got)
    assert not slots[space.vertex == n].any()
    want = PML.aggregate_repulsion(x, tables, w, REPEL, EPS, exact=True)
    scale = PML.aggregate_repulsion(x, tables, w, REPEL, EPS, exact=True,
                                    absolute=True)
    assert bool(((got - want).abs() <= 1e-12 * scale).all())


def test_members_must_come_first():
    """A row with a ghost before a member is no kernel B layout."""
    with pytest.raises(ValueError, match="members first"):
        PML._table_space([np.array([[0, 3, 1, 3]], np.int32)], 3)


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
    counters are hand counts of the partition."""
    g, part, cA, rA = _level(np.random.default_rng(5), "small", "cpu")
    loop = _traced_refine(g, part, cA, rA, 3, "cpu")
    sizes = np.bincount(part.vertex_to_agg_numpy(), minlength=part.num_aggs)
    assert loop["counts"] == {
        "ml_pairs": int((sizes * (sizes - 1)).sum()),
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
    its sum of |terms|; one launch, repeatable bitwise, and the layout's
    slot space and the plain tables give the same bits."""
    v2a, m = _partition(kind)
    n = v2a.size
    part = interop.partition(v2a, m)
    tables = PML.build_member_buckets(part)
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.uniform(-1, 1, (n, 3)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(1, 4, n).astype(np.float32))
    x64, w64 = x.double(), w.double()
    want = PML.aggregate_repulsion(x64, tables, w64, REPEL, EPS, exact=True)
    scale = PML.aggregate_repulsion(x64, tables, w64, REPEL, EPS, exact=True,
                                    absolute=True)
    space = PML.repulsion_members(part, dev)
    assert isinstance(space, BR.SlotSpace) and space.vertex.is_cuda
    xd, wd = x.to(dev), w.to(dev)
    exact = repulsion == "exact"
    before = cuda.LAUNCHES["bucket_repulsion"]
    got = PML.aggregate_repulsion(xd, space, wd, REPEL, EPS, exact=exact)
    assert cuda.LAUNCHES["bucket_repulsion"] == before + 1
    err = (got.cpu().double() - want).abs()
    assert bool((err <= 256 * 2.0**-24 * scale).all()), float(err.max())
    assert torch.equal(PML.aggregate_repulsion(xd, space, wd, REPEL, EPS,
                                               exact=exact), got)
    assert torch.equal(PML.aggregate_repulsion(xd, tables, wd, REPEL, EPS,
                                               exact=exact), got)


@pytest.mark.cuda
def test_kernel_path_raises_for_what_it_does_not_take(dev):
    """No fallback: float64 on the card, and the rounding scales, raise."""
    v2a, m = _partition("small")
    n = v2a.size
    space = PML.repulsion_members(interop.partition(v2a, m), dev)
    x = torch.rand((n, 3), device=dev, dtype=torch.float64)
    w = torch.ones(n, device=dev, dtype=torch.float64)
    with pytest.raises(ValueError):
        PML.aggregate_repulsion(x, space, w, REPEL, EPS)
    with pytest.raises(ValueError):
        PML.aggregate_repulsion(x.float(), space, w.float(), REPEL, EPS,
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


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_card_portable_and_slot_layouts_share_one_slot_space(dev, kind):
    """On the card, ``prepare_multilevel``'s slot space is
    ``prepare_refine``'s, slot for slot and task for task."""
    g, part, _, _ = _level(np.random.default_rng(5), kind, dev)
    portable = PML.prepare_multilevel(g, part, gp.MultilevelFAParams())
    tiled = MT.prepare_refine(
        g, part, gp.MultilevelFAParams(sampled_slots_threshold=0))
    for name in ("start", "slot", "vertex", "tasks", "aggs"):
        assert torch.equal(getattr(portable.members, name),
                           getattr(tiled.space, name))
