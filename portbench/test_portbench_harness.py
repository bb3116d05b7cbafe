"""The harness finds a cell's files by name: a cell that BENCHMARK.json
does not name yet runs from new entries alone, and every run's last line
keeps the contract."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from portbench.conftest import ROOT, make_checkout
from portbench import harness

FLAT_METRICS = ("flat_step.roofline_pct", "edge_spmm.roofline_pct",
                "fused_step.roofline_pct", "device_idle_pct.flat")


def check_line(line, chips=1):
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert isinstance(line["correct"], bool)
    assert line["attempted"] > 0 and line["failed"] >= 0
    dev = line["device"]
    for key in ("platform", "kind", "count", "memory_peak_bytes"):
        assert key in dev
    assert dev["count"] == chips
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(line)


def test_a_new_cell_runs_from_data_alone(tmp_path):
    """mesh3d-128 under flat is in no BENCHMARK.json of the repository:
    its entries and a shrunk copy of its configuration are all it
    takes."""
    root = make_checkout(tmp_path, [("mesh3d-128.flat", "mesh3d-128",
                                     "flat")], {"mesh3d-128": {"side": 6}},
                         [(m, ["mesh3d-128.flat"], "fa_entries_per_s")
                          for m in FLAT_METRICS])
    line = harness.run_cell(root, "mesh3d-128.flat", 2**31 + 11, 0.3, False,
                            "cpu")
    check_line(line)
    assert line["correct"] and line["failed"] == 0
    assert set(line["metrics"]) == {"fa_entries_per_s", "setup_s"}
    assert line["metrics"]["fa_entries_per_s"]["unit"] == "entries/s"
    assert set(line["checks"]) == {"force_gap", "step_gap"}
    traced = harness.run_cell(root, "mesh3d-128.flat", 2**31 + 11, 0.3,
                              True, "cpu")
    check_line(traced)
    # a CPU run has no device trace: no per-layer device metric is read
    assert traced["correct"] and traced["metrics"] == {}
    assert "busy_s" not in traced["device"]


def test_one_graph_per_configuration(tmp_path):
    """The graph is drawn from the configuration's seed: every run seed
    gets the same graph, another configuration seed another one."""
    root = make_checkout(tmp_path, [("lj-rmat24.flat", "lj-rmat24", "flat")],
                         {"lj-rmat24": {"scale": 9}})
    cell = harness.resolve(root, "lj-rmat24.flat")
    a, b = (harness.Context(root, cell, seed, 1.0, False, "cpu", 0.0).graph()
            for seed in (2**31 + 7, 2**31 + 8))
    assert a["n"] == b["n"]
    for k in ("senders", "receivers"):
        assert a[k].equal(b[k])
    cell.config = {**cell.config, "seed": 2}
    other = harness.Context(root, cell, 2**31 + 7, 1.0, False, "cpu",
                            0.0).graph()
    assert other["senders"].shape != a["senders"].shape or \
        not other["senders"].equal(a["senders"])
    s, r = a["senders"], a["receivers"]
    assert bool((s != r).all())
    key = s * a["n"] + r
    assert bool((key[1:] > key[:-1]).all())  # sorted, no duplicates
    assert bool((s.bincount(minlength=a["n"]) > 0).all())  # none isolated
    rev = (r * a["n"] + s).sort().values
    assert rev.equal(key)  # symmetric


def test_each_cell_reports_its_metrics():
    for cell in json.load(open(os.path.join(ROOT, "BENCHMARK.json")))[
            "workloads"]:
        c = harness.resolve(ROOT, cell["name"])
        names = {m["name"] for m in c.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert c.per_layer
        for m in c.per_layer:
            assert os.path.isfile(os.path.join(
                ROOT, "portbench", "metrics", f"{m['name']}.py"))


def test_no_card_no_result():
    """Without a CUDA device the command exits non-zero and prints no
    result (this machine has none; on the card the test skips)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "portbench", "run.py"),
         "--workload", "lj-rmat24.flat", "--seed", str(2**31 + 3),
         "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
        timeout=120, cwd=ROOT)
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_banned_modules_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "graph_embed_tpu_torch_x", sys)
    assert harness.banned_loaded() == []
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert harness.banned_loaded() == ["jaxlib"]
