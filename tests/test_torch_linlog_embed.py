"""The LinLog embed on the port's normal path, on the CPU at a small size:
``embed_graph`` with LinLog base and refine parameters held stage by
stage to the benchmark's plain float64 reference
(``portbench/reference/embed_linlog.py``), the portable refinement's
sub-spans and counters, the coarsest radii over the coarse graph's
edges, and the member tables built in sorted order against the dense
build.  The file imports
neither JAX nor the JAX package."""

import dataclasses

import numpy as np
import pytest
import torch

import graph_embed_tpu_torch as gp
from graph_embed_tpu_torch import interop
from graph_embed_tpu_torch.embed.driver import build_galerkin_chain
from graph_embed_tpu_torch.forceatlas import multilevel as pml
from graph_embed_tpu_torch.ops import bucket_repulsion as BR
from portbench.generators import community_rmat as C
from portbench.program import program_graph
from portbench.reference import embed as E
from portbench.reference import embed_linlog as L
from portbench.reference import hierarchy as H

FA = dict(ks=0.1, ksmax=1.0, repel=1.0, attract=1.0, gravity=1.0,
          epsilon=1e-5, tolerate=1.0, pull=100.0)
LINLOG = dict(base_params=gp.ForceAtlasParams(linlog=True),
              refine_params=gp.MultilevelFAParams(linlog=True))
BASE_ITERS = 300
REFINE_ITERS = 20


def _graph():
    """A seeded community R-MAT graph drawn by the benchmark's generator
    (its largest connected component), with no host copy, as the benchmark
    hands it to the program."""
    arrays = C.build(dict(scale=9, communities=4, edge_factor=4, a=0.57,
                          b=0.19, c=0.19, inter_frac=0.05), 3, "cpu")
    return program_graph(arrays)


@pytest.fixture(scope="module")
def entry():
    """``embed_graph``'s LinLog embed of the graph in float32 (the device
    coarsener, the Galerkin chain, the base case, the portable route)."""
    g = _graph()
    metrics = gp.MetricsLogger()
    coords, res = gp.embed_graph(g, 3, device="cpu", seed=11,
                                 base_iterations=BASE_ITERS,
                                 refine_iterations=REFINE_ITERS,
                                 metrics=metrics, **LINLOG)
    return g, coords, res, metrics.records


@pytest.fixture(scope="module")
def embedded(entry):
    """The same hierarchy embedded in float64 (the Galerkin chain of the
    graph with float64 weights), with each level's outputs and the
    records."""
    g32, _, res, _ = entry
    g = dataclasses.replace(g32, weights=g32.weights.double())
    graphs = build_galerkin_chain(g, res.levels)
    levels = {}

    def on_level(l, coords, part, coords_A, r_A):
        levels[l] = (coords.clone(), coords_A.clone(), r_A.clone())

    metrics = gp.MetricsLogger()
    coords = gp.embed(graphs, res.levels, 3, device="cpu", seed=11,
                      base_iterations=BASE_ITERS,
                      refine_iterations=REFINE_ITERS, metrics=metrics,
                      on_level=on_level, **LINLOG)
    return g, coords, res, levels, metrics.records


def _start(rows, seed):
    """The program's start on a float64 graph: U(-1, 1)^3 drawn in
    float64 (``E.uniform_start`` draws the float32 one)."""
    gen = torch.Generator().manual_seed(int(seed))
    return torch.rand((rows, 3), generator=gen, dtype=torch.float64) * 2 - 1


def _chain(g, res):
    s, r, w = g.to_coo_numpy()
    chain = [(s, r, np.asarray(w, np.float64), g.n)]
    for p in res.levels:
        v2a = p.vertex_to_agg_numpy()
        chain.append((*H.galerkin(*chain[-1][:3], v2a, p.num_aggs),
                      p.num_aggs))
    return chain


def test_linlog_base_case_matches_reference(embedded):
    """The base case from its documented start against the reference's
    float64 LinLog layout."""
    g, _, res, levels, _ = embedded
    k = len(res.levels)
    cs, cr, cw, m = _chain(g, res)[k]
    seeds = E.level_seeds(11, k)
    x0 = _start(m, seeds[k])
    got = levels[k - 1][1]
    want = L.base_case(cs, cr, cw, m, x0, BASE_ITERS, FA)
    assert harness_gap(got, want) < 1e-6


def harness_gap(got, want):
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max())


def test_linlog_refinement_matches_reference_per_level(embedded):
    """Each level's portable LinLog refinement, from the parent balls the
    program packed it into and the route's start (row i for vertex i),
    against the reference's, within 1e-6 of the parent radius."""
    g, _, res, levels, _ = embedded
    k = len(res.levels)
    chain = _chain(g, res)
    seeds = E.level_seeds(11, k)
    for l in range(k):
        coords, cA, rA = levels[l]
        s, r, w, n = chain[l]
        x0 = _start(n, seeds[l])
        v2a = res.levels[l].vertex_to_agg_numpy()
        want = L.refine(s, r, w, v2a, cA, rA, x0, FA, REFINE_ITERS,
                        pair_block=97)
        per = (coords - want).abs().amax(1) / rA[torch.from_numpy(v2a)]
        assert float(per.max()) < 1e-6, l


def test_linlog_stage_radii_match_reference(embedded):
    """The coarsest radii from the base layout, as the benchmark checks
    them (the sweep in float32)."""
    g, _, res, levels, _ = embedded
    k = len(res.levels)
    cs, cr, _, _ = _chain(g, res)[k]
    c_in = levels[k - 1][1].numpy()
    want = L.radii_top(c_in.astype(np.float32), cs, cr)
    np.testing.assert_allclose(levels[k - 1][2].numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("m", [300, 900])
def test_top_radii_over_coarse_edges_match_reference(m):
    """Above 512 coarsest aggregates the program sweeps the coarsest
    graph's edges, not every pair; the reference does the same, and a
    vertex no edge touches gets half its nearest distance (the two sides
    form that distance in another order: 2e-6 of the radius)."""
    from graph_embed_tpu_torch.embed.radii import radii_top_level

    rng = np.random.default_rng(m)
    c = rng.normal(size=(m, 3)).astype(np.float32)
    e = rng.integers(0, m - 5, (2, 4 * m))
    e = e[:, e[0] != e[1]]
    key = np.unique(np.concatenate([e[0] * m + e[1], e[1] * m + e[0]]))
    s, r = key // m, key % m
    got = radii_top_level(torch.from_numpy(c), coarse_edges=(s, r))
    want = L.radii_top(c, s, r)
    touched = np.zeros(m, bool)
    touched[s] = True
    np.testing.assert_array_equal(got.numpy()[touched], want[touched])
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6)


def test_entry_point_hierarchy_matches_reference_coarsener(entry):
    """``embed_graph``'s LinLog embed of the card-only graph: its
    hierarchy is the reference coarsener's, label for label, every level
    refines on the portable route and the layout is finite."""
    g, coords, res, records = entry
    s, r, _ = g.to_coo_numpy()
    ref = H.hierarchy(s, r, np.ones(s.size, np.float32), g.n, 0.1)
    assert len(ref) == len(res.levels) >= 2
    for want, p in zip(ref, res.levels):
        np.testing.assert_array_equal(p.vertex_to_agg_numpy(), want)
    assert {r["route"] for r in records if r["phase"] == "refine"} == {
        "portable"}
    assert bool(torch.isfinite(coords).all())


def _subs(records, name):
    return [sub for rec in records for sub in rec.get("sub", ())
            if sub["name"] == name]


def test_portable_route_spans_and_counters(embedded):
    """Every refined level's layout holds ``ml.intra`` then
    ``ml.members``; its refine holds one ``ml.loop`` (with the
    repulsion's counters) and an ``ml.repulsion`` per iteration inside
    it; the counters equal the hand counts of the level's partition."""
    _, _, res, _, records = embedded
    k = len(res.levels)
    layouts = [r for r in records if r["phase"] == "layout"]
    refines = [r for r in records if r["phase"] == "refine"]
    assert [r["level"] for r in layouts] == list(range(k - 1, -1, -1))
    for rec in layouts:
        assert [s["name"] for s in rec["sub"]] == ["ml.intra", "ml.members"]
        assert rec["sub"][0]["counts"]["ml_intra_entries"] > 0
    for rec, part in zip(refines, res.levels[::-1]):
        assert rec["route"] == "portable"
        loop, = [s for s in rec["sub"] if s["name"] == "ml.loop"]
        reps = [s for s in rec["sub"] if s["name"] == "ml.repulsion"]
        assert loop["iterations"] == REFINE_ITERS
        assert len(reps) == REFINE_ITERS
        ix = rec["sub"].index(loop)
        assert all(s["parent"] == ix for s in reps)
        assert all(loop["t0_ns"] <= s["t0_ns"] <= s["t1_ns"] <= loop["t1_ns"]
                   for s in reps)
        sizes = np.bincount(part.vertex_to_agg_numpy(),
                            minlength=part.num_aggs)
        assert loop["counts"] == {
            "ml_pairs": int((sizes * (sizes - 1)).sum()),
            "ml_largest_aggregate": int(sizes.max())}
    base, = _subs(records, "base.loop")
    assert base["counts"]["base_attraction_entries"] > 0


def test_pair_counts_of_a_known_partition():
    """Aggregates of 3, 1 and 5 members: 3*2 + 0 + 5*4 ordered pairs, and
    in kernel B's slot space one class of 8 slots per aggregate (sizes up
    to 8), each aggregate's members first in vertex order."""
    v2a = np.array([0, 2, 0, 1, 2, 2, 0, 2, 2], np.int32)
    part = interop.partition(v2a, 3)
    g = gp.synth.ring_of_cliques(3, 3)
    layout = pml.prepare_multilevel(g, part, gp.MultilevelFAParams())
    assert (layout.pairs, layout.largest) == (26, 5)
    space = BR.slot_space(v2a, 3)
    assert [(b.S, b.m_b) for b in space.buckets] == [(8, 3)]
    assert space.slot.tolist() == [0, 16, 1, 8, 17, 18, 2, 19, 20]


def _dense_buckets(part, pad):
    """The member tables cut from the dense [m, largest] table, each row an
    aggregate's vertices in increasing id, padded with n."""
    v2a = part.vertex_to_agg_numpy()
    n, out = part.n, []
    counts = np.bincount(v2a, minlength=part.num_aggs)
    full = np.full((part.num_aggs, max(int(counts.max()), 1)), n, np.int64)
    for a in range(part.num_aggs):
        ids = np.flatnonzero(v2a == a)
        full[a, :ids.size] = ids
    cap, remaining = pad, np.arange(part.num_aggs)
    while remaining.size:
        in_b = remaining[counts[remaining] <= cap]
        remaining = remaining[counts[remaining] > cap]
        if in_b.size:
            w = min(cap, full.shape[1])
            arr = np.full((in_b.size, -(-w // pad) * pad), n, np.int32)
            arr[:, :w] = full[in_b, :w]
            out.append(arr)
        cap *= 2
    return out


@pytest.mark.parametrize("shape", ["uniform", "skewed", "empty_aggregates",
                                   "singletons"])
@pytest.mark.parametrize("pad", [4, 8])
def test_member_buckets_equal_the_dense_build(shape, pad):
    """The sorted-order build's tables are bitwise the dense table's."""
    rng = np.random.default_rng(abs(hash((shape, pad))) % 2**32)
    n = 700
    if shape == "uniform":
        m, v2a = 90, rng.integers(0, 90, n)
    elif shape == "skewed":
        m = 60
        p = rng.pareto(0.8, m) + 1e-3
        v2a = rng.choice(m, n, p=p / p.sum())
    elif shape == "empty_aggregates":
        m, v2a = 200, rng.integers(0, 40, n) * 5
    else:
        m, v2a = n, rng.permutation(n)
    part = interop.partition(v2a.astype(np.int32), m)
    got = pml.build_member_buckets(part, pad_multiple=pad)
    want = _dense_buckets(part, pad)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
