"""The LinLog embed cell through the harness on the CPU at a small size: a
sound run is correct; the control and each fault the cell can have come
out not correct; the new readers read the program's sub-spans and
counters and give None where a record lacks them; the reference loads
neither JAX nor the program.  On the card (marker ``cuda``) a small cell,
traced, reports every per-layer metric of the cell.

    python -m pytest -p no:cacheprovider portbench/test_portbench_linlog.py
"""

from __future__ import annotations

import json
import os

import pytest
import torch

from portbench import control, harness
from portbench.conftest import ROOT, make_checkout
from portbench.test_portbench_nojax import BANNED, loaded_tops

CELL = "lj-community.embed-linlog"
SEED = 2**31 + 57
SMALL = {"scale": 9, "communities": 4, "edge_factor": 4}
NEW_METRICS = ("linlog.members_s", "linlog.intra_s", "linlog.refine_iter_us",
               "linlog.repulsion.roofline_pct", "edge_linlog.roofline_pct")
EMBED_METRICS = ("embed.partition_s", "embed.galerkin_s", "embed.base_s",
                 "embed.radii_s", "embed.layout_s", "embed.refine_s",
                 "embed.base_iter_us", "embed.base_card_iter_us",
                 "embed.graph_to_host_mb", "device_idle_pct.embed")


def linlog_checkout(tmp, sizes):
    """A checkout with the LinLog cell alone, its graph and warm-up graph
    shrunk, ``embed_s`` reported in it."""
    root = make_checkout(tmp, [(CELL, "lj-community", "embed-linlog")],
                         {"lj-community": sizes},
                         [(m, [CELL], "embed_s")
                          for m in NEW_METRICS + EMBED_METRICS])
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as fh:
        bench = json.load(fh)
    for m in bench["end_to_end"]:
        if m["name"] == "embed_s":
            m["workloads"] = [CELL]
    with open(path, "w") as fh:
        json.dump(bench, fh)
    path = os.path.join(root, "portbench", "traffic", "embed-linlog.json")
    with open(path) as fh:
        traffic = json.load(fh)
    traffic["warmup_graph"].update(scale=7, communities=2)
    with open(path, "w") as fh:
        json.dump(traffic, fh)
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return linlog_checkout(tmp_path_factory.mktemp("linlog"), SMALL)


def run(root, trace=False, seed=SEED):
    return harness.run_cell(root, CELL, seed, 0.1, trace, "cpu")


def test_sound_run_is_correct(root):
    line = run(root)
    assert line["correct"] and line["failed"] == 0, line["checks"]
    assert set(line["metrics"]) == {"embed_s", "setup_s"}
    assert list(line["checks"]) == ["hierarchy_mismatch", "base_gap",
                                    "radii_gap", "refine_gap",
                                    "refine_worst"]
    traced = run(root, trace=True, seed=SEED + 1)
    assert traced["correct"]
    # the spans are read on the CPU too; the card's time and the bytes
    # copied off the card are not
    assert set(traced["metrics"]) == {
        "linlog.members_s", "linlog.intra_s", "linlog.refine_iter_us",
        "embed.partition_s", "embed.galerkin_s", "embed.base_s",
        "embed.radii_s", "embed.layout_s", "embed.refine_s",
        "embed.base_iter_us"}


def test_control_is_not_correct(root):
    for line in control.readings(root, CELL, [SEED, SEED + 1, SEED + 2],
                                 0.1, device="cpu"):
        assert not line["correct"]


def _linear(x, csr, *, attract, eps):
    """LinLog attraction with the log term dropped: w (x_j - x_i)."""
    from graph_embed_tpu_torch.ops import edge_spmm as ES

    rows = ES._rows(csr)
    diff = x[csr.col.long()] - x[rows]
    out = torch.zeros((csr.n_rows, x.shape[1]), dtype=x.dtype)
    return out.index_add_(0, rows, diff * (attract * csr.w)[:, None])


@pytest.mark.parametrize("fault", ["base_unchanged", "refine_unchanged",
                                   "half_pairs", "log_dropped"])
def test_fault_is_not_correct(root, fault, monkeypatch):
    from graph_embed_tpu_torch.embed import driver as D
    from graph_embed_tpu_torch.forceatlas import multilevel as ML
    from graph_embed_tpu_torch.ops import edge_spmm as ES

    if fault == "base_unchanged":
        # the base case returns its start unchanged
        base = D.force_atlas
        monkeypatch.setattr(D, "force_atlas", lambda *a, **k: base(
            *a, **{**k, "iterations": 0}))
    elif fault == "refine_unchanged":
        # every level's refinement leaves its start where it was
        prepare, refine = D._ROUTES["portable"]
        monkeypatch.setitem(D._ROUTES, "portable", (
            prepare, lambda *a, **k: refine(*a, **{**k, "iterations": 0})))
    elif fault == "half_pairs":
        # the first half of every member table's aggregates feel no
        # repulsion from one another
        rep = ML.aggregate_repulsion

        def half(coords, members, *a, **k):
            n = coords.shape[0]
            cut = tuple(torch.where(
                torch.arange(t.shape[0])[:, None] < t.shape[0] // 2,
                torch.full_like(t, n), t) for t in members)
            return rep(coords, cut, *a, **k)
        monkeypatch.setattr(ML, "aggregate_repulsion", half)
    else:
        monkeypatch.setattr(ES, "linlog", _linear)
    line = run(root)
    assert not line["correct"] and line["failed"] == 1, line["checks"]


def test_reference_hierarchy_is_kept_per_checkout(root):
    """The driver's reference hierarchy is H.hierarchy's, computed once per
    checkout and configuration: the second call reads the kept copy, and
    another configuration keeps its own."""
    import glob

    import numpy as np

    from portbench.reference import hierarchy as H

    driver = harness.load_module(root, "drivers", "embed_linlog")
    cell = harness.resolve(root, CELL)
    ctx = harness.Context(root=root, cell=cell, seed=SEED, seconds=0.1,
                          trace=False, device="cpu", t0=0.0)
    arrays = ctx.graph()
    s, r = arrays["senders"].numpy(), arrays["receivers"].numpy()
    n = arrays["n"]
    want = H.hierarchy(s, r, np.ones(s.size, np.float32), n,
                       cell.traffic["coarsening_factor"])
    kept = os.path.join(root, "portbench", "_cache", "hierarchy-*.npz")
    for _ in range(2):
        got = driver.reference_hierarchy(ctx, H, s, r, n)
        assert len(got) == len(want) and len(glob.glob(kept)) == 1
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    cell.config = {**cell.config, "seed": cell.config["seed"] + 1}
    driver.reference_hierarchy(ctx, H, s, r, n)
    assert len(glob.glob(kept)) == 2


def reader(name):
    return harness.load_module(ROOT, "metrics", name).read


def sub(name, seconds, t=(0, 1), **fields):
    return {"name": name, "seconds": seconds, "t0_ns": t[0], "t1_ns": t[1],
            "parent": None, **fields}


def level(l, n, members, intra, loop, iters, pairs, entries, traced=False):
    """A level's layout and refine records as the program and the driver
    write them."""
    lay = {"phase": "layout", "level": l, "n": n, "seconds": members + intra,
           "sub": [sub("ml.intra", intra,
                       counts={"ml_intra_entries": entries}),
                   sub("ml.members", members)]}
    ref = {"phase": "refine", "level": l, "n": n, "route": "portable",
           "seconds": loop + 0.1,
           "sub": [sub("ml.loop", loop, iterations=iters,
                       counts={"ml_pairs": pairs, "ml_padded_pairs": 2 * pairs,
                               "ml_largest_aggregate": 9})]}
    if traced:
        ref["kernels"] = {"edge_linlog": {"calls": iters, "seconds": 0.01}}
        ref["repulsion"] = {"seconds": 0.5, "calls": 3 * iters}
    return [lay, ref]


@pytest.fixture
def rec():
    base = {"phase": "base", "n": 1000, "seconds": 2.0,
            "sub": [sub("base.loop", 1.9, iterations=12_000,
                        counts={"base_attraction_entries": 20_000})]}
    traced_base = {**base, "kernels": {"edge_linlog": {"calls": 12_000,
                                                       "seconds": 0.12}}}
    return {"dim": 3, "trace": {"busy_s": 5.0, "window_s": 30.0},
            "embeds": [
                {"seconds": 10.0, "traced": False, "spans": [
                    base, *level(1, 10_000, 0.1, 0.2, 0.4, 100, 10**6, 10**5),
                    *level(0, 100_000, 0.3, 0.4, 1.6, 100, 10**7, 10**6)]},
                {"seconds": 12.0, "traced": False, "spans": [
                    base, *level(1, 10_000, 0.3, 0.2, 0.6, 100, 10**6, 10**5),
                    *level(0, 100_000, 0.3, 0.6, 2.4, 100, 10**7, 10**6)]},
                {"seconds": 20.0, "traced": True, "spans": [
                    traced_base,
                    *level(1, 10_000, 9, 9, 9, 100, 10**6, 10**5, True),
                    *level(0, 100_000, 9, 9, 9, 100, 10**7, 10**6, True)]}]}


def test_readers_of_the_portable_route(rec):
    from portbench import roofline as R
    from portbench import roofline_linlog as RL

    assert reader("linlog.members_s")(rec) == pytest.approx(0.5)
    assert reader("linlog.intra_s")(rec) == pytest.approx(0.7)
    # (2.0 s / 200 + 3.0 s / 200) / 2 iterations
    assert reader("linlog.refine_iter_us")(rec) == pytest.approx(12_500.0)
    least = 100 * (R.bound_s(*RL.member_repulsion(10_000, 3, 10**6))
                   + R.bound_s(*RL.member_repulsion(100_000, 3, 10**7)))
    assert reader("linlog.repulsion.roofline_pct")(rec) == pytest.approx(
        100 * least / 1.0)
    least = (12_000 * R.bound_s(*RL.edge_linlog(1000, 1000, 20_000, 3))
             + 100 * R.bound_s(*RL.edge_linlog(10_000, 10_000, 10**5, 3))
             + 100 * R.bound_s(*RL.edge_linlog(100_000, 100_000, 10**6, 3)))
    assert reader("edge_linlog.roofline_pct")(rec) == pytest.approx(
        100 * least / 0.14)


@pytest.mark.parametrize("name", NEW_METRICS)
def test_none_without_the_sub_spans(rec, name):
    """A record from a program without the portable route's sub-spans and
    counters (a parent's) reads None, as does one without embeds."""
    for e in rec["embeds"]:
        for sp in e["spans"]:
            sp.pop("sub", None)
            sp.pop("repulsion", None)
    assert reader(name)(rec) is None
    assert reader(name)({"embeds": [], "dim": 3}) is None


def test_card_time_needs_the_trace(rec):
    rec.pop("trace")
    assert reader("linlog.repulsion.roofline_pct")(rec) is None
    assert reader("edge_linlog.roofline_pct")(rec) is None
    assert reader("linlog.members_s")(rec) == pytest.approx(0.5)


def test_the_linlog_reference_loads_nothing_of_the_program():
    tops = loaded_tops(f"""
import sys
sys.path.insert(0, {ROOT!r})
import portbench.reference.embed_linlog
""")
    assert "torch" in tops
    assert not tops & (BANNED | {"graph_embed_tpu_torch"})


@pytest.mark.cuda
def test_small_linlog_cell_on_the_card(card, tmp_path):
    small = linlog_checkout(tmp_path, {"scale": 14, "communities": 16})
    traced = harness.run_cell(small, CELL, 2**31 + 61, 1, True, card)
    assert traced["correct"], traced["checks"]
    assert set(traced["metrics"]) == set(NEW_METRICS + EMBED_METRICS)
    for name in ("linlog.repulsion.roofline_pct", "edge_linlog.roofline_pct"):
        assert 0 < traced["metrics"][name]["value"] <= 105
    for line in control.readings(small, CELL, [2**31 + 62], 1, device=card):
        assert not line["correct"]
