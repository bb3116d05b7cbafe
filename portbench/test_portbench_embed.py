"""The embed cell through the harness on the CPU at a small size: a sound
run is correct, and the control and each fault the cell can have come
out not correct."""

from __future__ import annotations

import pytest
import torch

from portbench import control, harness
from portbench.conftest import make_checkout

SEED = 2**31 + 31
EMBED_METRICS = ("embed.partition_s", "embed.galerkin_s", "embed.base_s",
                 "embed.radii_s", "embed.layout_s", "embed.refine_s",
                 "embed.base_busy_pct", "device_idle_pct.embed")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_checkout(tmp_path_factory.mktemp("embed"),
                         [("mesh3d-128.embed", "mesh3d-128", "embed")],
                         {"mesh3d-128": {"side": 12}},
                         [(m, ["mesh3d-128.embed"], "embed_s")
                          for m in EMBED_METRICS])


def run(root, trace=False):
    return harness.run_cell(root, "mesh3d-128.embed", SEED, 0.1, trace,
                            "cpu")


def test_sound_run_is_correct(root):
    line = run(root)
    assert line["correct"] and line["failed"] == 0
    assert set(line["metrics"]) == {"embed_s", "setup_s"}
    assert list(line["checks"]) == ["hierarchy_mismatch", "base_gap",
                                    "radii_gap", "refine_gap", "refine_worst"]
    traced = run(root, trace=True)
    assert traced["correct"]
    # the spans are read on the CPU too; the card's shares are not
    assert set(traced["metrics"]) == {m for m in EMBED_METRICS
                                      if m.endswith("_s")}


def test_control_is_not_correct(root):
    for line in control.readings(root, "mesh3d-128.embed", [SEED, SEED + 1,
                                                            SEED + 2], 0.1,
                                 device="cpu"):
        assert not line["correct"]


@pytest.mark.parametrize("fault", ["base_unchanged", "refine_half",
                                   "answer_altered", "partition_altered"])
def test_fault_is_not_correct(root, fault, monkeypatch):
    from graph_embed_tpu_torch.embed import driver as D
    from graph_embed_tpu_torch.partition import hierarchy as PH

    if fault == "base_unchanged":
        # the base case returns its start unchanged
        base = D.force_atlas
        monkeypatch.setattr(D, "force_atlas", lambda *a, **k: base(
            *a, **{**k, "iterations": 0}))
    elif fault in ("refine_half", "answer_altered"):
        prepare, refine = D._ROUTES["tiled"]

        def faulty(g, part, coords_A, r_A, dim, **k):
            if fault == "refine_half":
                # half of the refinement's iterations left out
                return refine(g, part, coords_A, r_A, dim,
                              **{**k, "iterations": k["iterations"] // 2})
            # two far vertices' answers written to each other's rows
            out = refine(g, part, coords_A, r_A, dim, **k).clone()
            rows = torch.tensor([0, g.n - 1])
            out[rows] = out[rows.flip(0)]
            return out
        monkeypatch.setitem(D._ROUTES, "tiled", (prepare, faulty))
    else:
        # two vertices of the finest level in each other's aggregates
        run_rounds = PH._run_rounds

        def faulty_rounds(*a, **k):
            st, levels, sizes = run_rounds(*a, **k)
            v2a = levels[0].vertex_to_agg.clone()
            v2a[[0, -1]] = v2a[[-1, 0]]
            levels[0] = type(levels[0])(v2a, levels[0].num_aggs)
            return st, levels, sizes
        monkeypatch.setattr(PH, "_run_rounds", faulty_rounds)
    line = run(root)
    assert not line["correct"] and line["failed"] == 1


def test_busy_shares_divide_by_unprofiled_seconds(root):
    """The base case's busy share and the embed's idle share take the
    card's busy seconds from the profiled embed and the seconds from the
    window's embeds, which ran without the profiler."""
    def span(phase, seconds, busy=None):
        sp = {"phase": phase, "seconds": seconds}
        if busy is not None:
            sp["busy_s"] = busy
        return sp

    rec = {"trace": {"busy_s": 1.5, "window_s": 20.0},
           "embeds": [
               {"seconds": 10.0, "traced": False,
                "spans": [span("base", 8.0), span("layout", 1.0)]},
               {"seconds": 12.0, "traced": False,
                "spans": [span("base", 9.0), span("layout", 2.0)]},
               {"seconds": 20.0, "traced": True,
                "spans": [span("base", 15.0, 0.85), span("layout", 2.0,
                                                          0.65)]}]}
    busy = harness.load_module(root, "metrics", "embed.base_busy_pct")
    idle = harness.load_module(root, "metrics", "device_idle_pct.embed")
    assert busy.read(rec) == pytest.approx(100 * 0.85 / 8.5)
    assert idle.read(rec) == pytest.approx(100 * (1 - 1.5 / 11.0))
    rec.pop("trace")
    assert busy.read(rec) is None and idle.read(rec) is None
