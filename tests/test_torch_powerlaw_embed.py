"""The default embed of a power-law graph's largest component on the slot
route, on the CPU at a small size: the benchmark's generator
(``portbench/generators/rmat_lcc.py``), the plain reference of the
sampled within-aggregate estimator (``portbench/reference/
embed_sampled.py``) against the program's, a small embed whose hub
aggregates take the estimator held to that reference under the cell's
limits (and a uniform stream shifted by one draw caught), the slot
route's ``slot.sampled`` sub-span and counters, the partition-ordered
flat cell's context and check, the new readers, and the rule that the
new reference loads neither JAX nor the program.  The file imports
neither JAX nor the JAX package."""

import functools
import json
import os

import numpy as np
import pytest
import torch

import graph_embed_tpu_torch as gp
from graph_embed_tpu_torch.forceatlas import multilevel_tiled as MT
from graph_embed_tpu_torch.graph.reorder import apply_order, partition_order
from portbench import harness
from portbench.conftest import ROOT, make_checkout
from portbench.drivers import embed_powerlaw as DP
from portbench.drivers import flat_ordered as FO
from portbench.generators import community_rmat, rmat, rmat_lcc
from portbench.program import program_graph
from portbench.reference import embed as E
from portbench.reference import embed_sampled as R
from portbench.reference import hierarchy as H
from portbench.test_portbench_nojax import BANNED, loaded_tops

with open(os.path.join(ROOT, "portbench", "traffic",
                       "embed-powerlaw.json")) as _fh:
    TRAFFIC = json.load(_fh)
SMALL = dict(scale=11, edge_factor=2.08, a=0.57, b=0.19, c=0.19)
# hub aggregates at this size: classes of 32 slots and more are sampled
THRESHOLD = 32
SEED = 5
REFINE_ITERS = TRAFFIC["refine_iterations"]


@pytest.mark.parametrize("seed", [1, 2**31 + 3])
def test_lcc_generator_keeps_one_connected_symmetric_component(seed):
    cfg = dict(SMALL, scale=12)
    g = rmat_lcc.build(cfg, seed, "cpu")
    again = rmat_lcc.build(cfg, seed, "cpu")
    assert g["n"] == again["n"]
    assert torch.equal(g["senders"], again["senders"])
    assert torch.equal(g["receivers"], again["receivers"])
    s, r, n = g["senders"], g["receivers"], g["n"]
    key = s * n + r
    assert bool((key[1:] > key[:-1]).all())       # sorted, no duplicate
    assert not bool((s == r).any())
    assert torch.equal(torch.sort(r * n + s).values, key)  # symmetric
    assert torch.equal(torch.unique(s), torch.arange(n))   # no isolated id
    assert bool((community_rmat.components(s, r, n) == 0).all())
    # the largest component of the whole draw
    full = rmat.build(cfg, seed, "cpu")
    label = community_rmat.components(full["senders"], full["receivers"],
                                      full["n"])
    assert n == int(torch.bincount(label).max()) < full["n"]
    assert program_graph(g).weights.eq(1.0).all()


@pytest.mark.parametrize("S", [16, 64])
def test_reference_estimator_matches_the_program(S):
    """The reference's float64 estimator against the program's float32
    ``bucket_repulsion_sampled`` on the same uniforms: every member of a
    bucket with ghosts, a one-member aggregate and a full one."""
    gen = torch.Generator().manual_seed(S)
    m, K, d = 5, 256, 3
    counts = torch.tensor([S, S // 2 + 1, 1, 3, S - 1])
    x3 = torch.rand((m, S, d), generator=gen) * 2.0 - 1.0
    valid = torch.arange(S)[None, :] < counts[:, None]
    w3 = torch.where(valid, torch.rand((m, S), generator=gen) * 5.0 + 1.0,
                     0.0)
    x3 = torch.where(valid[..., None], x3, 0.0)
    u = torch.rand((m, K), generator=gen)
    got = MT.bucket_repulsion_sampled(x3, w3, counts, u, 1.3, 1e-5)
    rows = valid.reshape(-1)
    agg = torch.arange(m).repeat_interleave(counts)
    first = torch.cumsum(counts, 0) - counts
    rank = torch.arange(int(counts.sum())) - first[agg]
    want = R.sampled_repulsion(
        x3.reshape(-1, d)[rows].double(), w3.reshape(-1)[rows].double(),
        agg, rank, first, counts, u, 1.3, 1e-5)
    assert torch.equal(got.reshape(-1, d)[~rows], torch.zeros(
        int((~rows).sum()), d))
    assert torch.equal(want[agg == 2], torch.zeros(1, d, dtype=torch.float64))
    scale = want.abs().max()
    torch.testing.assert_close(got.reshape(-1, d)[rows].double(), want,
                               rtol=1e-4, atol=1e-5 * float(scale))


def _embed(monkeypatch=None, shifted=False):
    """A small ``embed_graph`` of the largest component with hub
    aggregates on the estimator: (graph, result, each level's outputs,
    records)."""
    if shifted:
        sampled = MT.bucket_repulsion

        def one_draw_later(x, layout, repel, eps, *, num_samples=256,
                           generator=None):
            if layout.space.sampled_classes and generator is not None:
                torch.rand((1,), generator=generator, device=x.device)
            return sampled(x, layout, repel, eps, num_samples=num_samples,
                           generator=generator)
        monkeypatch.setattr(MT, "bucket_repulsion", one_draw_later)
    g = program_graph(rmat_lcc.build(SMALL, 7, "cpu"))
    levels = {}

    def on_level(l, coords, part, coords_A, r_A):
        levels[l] = tuple(a.clone().numpy() for a in (coords, coords_A, r_A))

    log = gp.MetricsLogger()
    _, res = gp.embed_graph(
        g, TRAFFIC["dim"], device="cpu", seed=SEED, base_iterations=300,
        refine_iterations=REFINE_ITERS, metrics=log, on_level=on_level,
        refine_params=gp.MultilevelFAParams(
            sampled_slots_threshold=THRESHOLD))
    return g, res, levels, log.records


@pytest.fixture(scope="module")
def embedded():
    return _embed()


def _refine_checks(g, res, levels):
    """Each level's (refine_gap, refine_worst) against the reference, as
    the cell's check computes them."""
    s, r, _ = g.to_coo_numpy()
    parts = [p.vertex_to_agg_numpy() for p in res.levels]
    chain = [(s, r, np.ones(s.size))]
    for v2a in parts:
        chain.append(H.galerkin(*chain[-1], v2a, int(v2a.max()) + 1))
    seeds = E.level_seeds(SEED, len(parts))
    t = dict(TRAFFIC, sampled_slots_threshold=THRESHOLD)
    return [DP.refine_gaps(chain[l], parts[l], levels[l][1], levels[l][2],
                           seeds[l], t, "cpu", torch.float64, levels[l][0])
            for l in range(len(parts))]


@pytest.mark.parametrize("stream", ["sound", "shifted"])
def test_small_embed_refine_held_to_the_reference(embedded, stream,
                                                  monkeypatch):
    """Every level's refinement, hub aggregates on the estimator, within
    the cell's limits of the reference from the program's uniforms; with
    the program's uniforms one draw later the check fails."""
    g, res, levels, _ = (embedded if stream == "sound"
                         else _embed(monkeypatch, shifted=True))
    counts = np.bincount(res.levels[0].vertex_to_agg_numpy())
    assert (R.size_classes(counts) >= THRESHOLD).sum() >= 5
    lim = TRAFFIC["limits"]
    checks = _refine_checks(g, res, levels)
    within = all(q <= lim["refine_gap"] and w <= lim["refine_worst"]
                 for q, w in checks)
    assert within == (stream == "sound"), checks


def test_records_hold_the_sampled_span_and_counters(embedded):
    """Each refined level's record counts the sampled aggregates, their
    (member, sample) pairs and kernel B's ordered member pairs, summed
    over the iterations, as the partition gives them; a level with
    sampled classes has one ``slot.sampled`` sub-span an iteration."""
    _, res, _, records = embedded
    refines = {rec["level"]: rec for rec in records
               if rec["phase"] == "refine"}
    assert sorted(refines) == list(range(len(res.levels)))
    K = gp.MultilevelFAParams().num_negative_samples
    for l, rec in refines.items():
        c = np.bincount(res.levels[l].vertex_to_agg_numpy())
        hub = R.size_classes(c) >= THRESHOLD
        ex = c[~hub]
        assert rec["counts"] == {
            "slot_sampled_buckets": int((hub & (c > 0)).sum()),
            "slot_sampled_pairs": int(c[hub].sum()) * K * REFINE_ITERS,
            "slot_pairs": int((ex * (ex - 1)).sum()) * REFINE_ITERS}
        subs = [sub for sub in rec.get("sub", ())
                if sub["name"] == "slot.sampled"]
        assert len(subs) == (REFINE_ITERS if hub.any() else 0)
        assert all(rec["t0_ns"] <= sub["t0_ns"] <= sub["t1_ns"]
                   <= rec["t1_ns"] for sub in subs)
    assert refines[0]["counts"]["slot_sampled_buckets"] > 0


@pytest.fixture(scope="module")
def embed_root(tmp_path_factory):
    """A checkout with the embed cell alone, its graph and warm-up graph
    cut to scale 11 and 8, hub aggregates at the test's threshold."""
    cell = "lj-rmat24-lcc.embed-powerlaw"
    readers = ("slot.sampled_s", "slot.sampled.roofline_pct",
               "slot.repulsion.roofline_pct", "embed.layout_s")
    root = make_checkout(tmp_path_factory.mktemp("powerlaw"),
                         [(cell, "lj-rmat24-lcc", "embed-powerlaw")],
                         {"lj-rmat24-lcc": {"scale": 11}},
                         [(m, [cell], "embed_s") for m in readers])
    for path, edit in (("BENCHMARK.json", _report_embed_s),
                       ("portbench/traffic/embed-powerlaw.json", _shrink)):
        with open(os.path.join(root, path)) as fh:
            data = json.load(fh)
        edit(data, cell)
        with open(os.path.join(root, path), "w") as fh:
            json.dump(data, fh)
    return root, cell


def _report_embed_s(bench, cell):
    for m in bench["end_to_end"]:
        if m["name"] == "embed_s":
            m["workloads"] = [cell]


def _shrink(traffic, cell):
    traffic["warmup_graph"]["scale"] = 8
    traffic["sampled_slots_threshold"] = THRESHOLD


@pytest.mark.parametrize("reference_dtype", [None, "bfloat16"])
def test_embed_cell_through_the_harness(embed_root, reference_dtype,
                                        monkeypatch):
    """A sound run of the cell (its hub aggregates on the estimator) is
    correct and its traced run reads the spans; the control, the
    reference in bfloat16 in the program's place, is not correct."""
    from graph_embed_tpu_torch.embed import driver as D

    root, cell = embed_root
    monkeypatch.setattr(D, "MultilevelFAParams", functools.partial(
        gp.MultilevelFAParams, sampled_slots_threshold=THRESHOLD))
    override = reference_dtype and {"reference_dtype": reference_dtype}
    line = harness.run_cell(root, cell, 2**31 + 77, 0.1,
                            reference_dtype is None, "cpu", traffic=override)
    assert list(line["checks"]) == ["hierarchy_mismatch", "base_gap",
                                    "radii_gap", "refine_gap",
                                    "refine_worst"]
    assert line["correct"] == (reference_dtype is None), line["checks"]
    if reference_dtype is None:
        # the card's times are not read on the CPU; the spans are
        assert set(line["metrics"]) == {"embed.layout_s"}


def _flat_checkout(tmp):
    cell = "lj-rmat24.flat-ordered"
    root = make_checkout(tmp, [(cell, "lj-rmat24", "flat-ordered")],
                         {"lj-rmat24": {"scale": 10}})
    return root, cell


def test_flat_ordered_context_is_partition_order(tmp_path):
    root, cell = _flat_checkout(tmp_path)
    ctx = FO.ordered(harness.Context(
        root=root, cell=harness.resolve(root, cell), seed=3, seconds=0.1,
        trace=False, device="cpu", t0=0.0))
    got = ctx.graph()
    g = program_graph(harness.Context.graph(ctx))
    perm = partition_order(g, 0.1)
    assert np.array_equal(ctx.perm, perm)
    assert not np.array_equal(perm, np.arange(g.n))
    want, _ = apply_order(g, perm)
    assert got["n"] == want.n
    assert torch.equal(got["senders"], want.senders)
    assert torch.equal(got["receivers"], want.receivers)
    again = ctx.graph()
    assert torch.equal(again["senders"], got["senders"])


def test_flat_ordered_cell_is_correct(tmp_path):
    """The cell's steps over the ordered arrays held to
    ``reference/flat_step.py`` through the harness."""
    root, cell = _flat_checkout(tmp_path)
    line = harness.run_cell(root, cell, 2**31 + 9, 0.2, False, "cpu")
    assert line["correct"] and line["failed"] == 0, line["checks"]
    assert set(line["checks"]) == {"force_gap", "step_gap"}


def test_readers_read_the_driver_and_none_without_it():
    """The new readers on a traced record (values from the formulas in
    their files) and on the parent's, which has neither the sub-span's
    card time nor the counters: None."""
    def load(name):
        return harness.load_module(ROOT, "metrics", name)

    refine = {"phase": "refine", "n": 1000, "seconds": 1.0,
              "sampled": {"seconds": 0.01, "calls": 300},
              "kernel_b": {"seconds": 0.02, "calls": 100},
              "counts": {"slot_sampled_buckets": 2,
                         "slot_sampled_pairs": 400 * 256 * 100,
                         "slot_pairs": 10**7}}
    rec = {"dim": 3, "samples": 256, "refine_iterations": 100,
           "trace": {"busy_s": 1.0, "window_s": 2.0},
           "embeds": [{"seconds": 2.0, "traced": True, "spans": [refine]}]}
    assert load("slot.sampled_s").read(rec) == pytest.approx(0.01)
    ops = 400 * 256 * 100 * 16
    assert load("slot.sampled.roofline_pct").read(rec) == pytest.approx(
        100.0 * ops / 67e12 / 0.01)
    least = max(8 * 600 * 3 * 100 / 3.35e12, 10**7 * 16 / 67e12)
    assert load("slot.repulsion.roofline_pct").read(rec) == pytest.approx(
        100.0 * least / 0.02)
    parent = {k: v for k, v in refine.items()
              if k not in ("sampled", "counts")}
    rec["embeds"][0]["spans"] = [parent]
    for name in ("slot.sampled_s", "slot.sampled.roofline_pct",
                 "slot.repulsion.roofline_pct"):
        assert load(name).read(rec) is None


def test_new_modules_load_no_jax():
    """The new reference loads neither JAX nor the program; the new
    drivers, generator and readers load no JAX."""
    tops = loaded_tops(f"""
import sys
sys.path.insert(0, {ROOT!r})
import portbench.reference.embed_sampled
""")
    assert not tops & (BANNED | {"graph_embed_tpu_torch"})
    tops = loaded_tops(f"""
import sys
sys.path.insert(0, {ROOT!r})
from portbench import harness
for kind, name in [("drivers", "embed_powerlaw"), ("drivers", "flat_ordered"),
                   ("generators", "rmat_lcc"), ("metrics", "slot.sampled_s"),
                   ("metrics", "slot.sampled.roofline_pct"),
                   ("metrics", "slot.repulsion.roofline_pct")]:
    harness.load_module({ROOT!r}, kind, name)
import graph_embed_tpu_torch.graph.reorder
""")
    assert not tops & BANNED, tops & BANNED
