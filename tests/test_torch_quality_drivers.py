"""The port's three quality tools against the JAX package's, on the CPU.

``scripts/quality_roster_torch.py``, ``scripts/quality_ab_torch.py`` and
``scripts/planted_precision_torch.py`` beside ``scripts/quality_roster.py``,
``scripts/quality_ab.py`` and ``scripts/planted_precision.py``, each loaded
from its path, on the same small inputs.  Every cache and record goes to
the test's tmp directory.

Tolerance: every integer (vertex and entry counts, aggregates, level
sizes, truth levels, pair counts) is equal, and so is each rounded ratio
of pair counts; the modularities (float32 sums on either side, rounded to
4 places) agree within 1e-5, Louvain's through networkx on both sides.
The roster's embed stress is finite (the random streams differ).
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

CPU = torch.device("cpu")
# a planted, a mesh and a power-law entry; the planted one also embeds
SMALL_ROSTER = ["synth:planted:8:40:0.3:0.01", "synth:mesh3d:8",
                "synth:rmat:10:8"]
EMBED_MAX_N = 400
Q_TOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread (the suite's workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def load(rel, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def json_lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def assert_records_equal(got, want):
    """Every key of ``want`` in ``got`` (which adds ``device``): numbers
    within Q_TOL where the key is a modularity or stress, seconds
    skipped, everything else equal."""
    assert set(got) == set(want) | {"device"}
    assert got["device"] == "cpu"
    for key, w in want.items():
        g = got[key]
        if key.endswith("seconds") or key == "stress":
            continue
        if "modularity" in key or key == "Q_at_level":
            np.testing.assert_allclose(g, w, rtol=0, atol=Q_TOL,
                                       err_msg=key)
        else:
            assert g == w, key


@pytest.mark.parametrize("spec", SMALL_ROSTER)
def test_roster_entry_matches_jax(spec):
    jax_roster = load("scripts/quality_roster.py", "quality_roster_jax")
    port_roster = load("scripts/quality_roster_torch.py",
                       "quality_roster_port")
    kw = dict(louvain_max_n=10 ** 6, do_embed=True, embed_max_n=EMBED_MAX_N)
    want = jax_roster.run_entry(spec, out_records=[], **kw)
    got = port_roster.run_entry(spec, out_records=[], device=CPU, **kw)
    assert_records_equal(got, want)
    assert "louvain_modularity" in got
    if got["n"] <= EMBED_MAX_N:
        assert np.isfinite(got["stress"])
    else:
        assert "stress" not in got


def test_roster_failed_entry_exits_1(tmp_path, monkeypatch, capsys):
    """An entry that raises is recorded, the rest of the roster runs, and
    the script exits 1; without networkx the Louvain column says so."""
    port_roster = load("scripts/quality_roster_torch.py",
                       "quality_roster_fail")
    monkeypatch.setattr(port_roster, "ROSTER",
                        ["synth:nosuchfamily:3", SMALL_ROSTER[0]])
    find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "networkx"
                        else find_spec(name, *a))
    out = tmp_path / "roster.jsonl"
    assert port_roster.main(["--cpu", "-o", str(out)]) == 1
    recs = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert json_lines(capsys.readouterr().out) == recs
    assert recs[0]["graph"] == "synth:nosuchfamily:3"
    assert "unknown synth family" in recs[0]["error"]
    assert recs[1]["graph"] == SMALL_ROSTER[0] and "error" not in recs[1]
    assert recs[1]["louvain"] == "networkx not installed"
    assert "louvain_modularity" not in recs[1]
    # the whole roster passing exits 0
    monkeypatch.setattr(port_roster, "ROSTER", SMALL_ROSTER[1:2])
    assert port_roster.main(["--device", "cpu", "--louvain-max-n", "0",
                             "-o", str(out)]) == 0


def test_quality_ab_matches_jax(tmp_path, monkeypatch, capsys):
    """On the rmat(12, 8) prep cache the JAX script wrote, the port's
    output (per-level Q of the cached hierarchy, the native greedy's
    aggregates and Q) equals the JAX script's."""
    import lj_scale_run
    import lj_scale_run_torch

    monkeypatch.setattr(lj_scale_run, "CACHE_ROOT", str(tmp_path))
    monkeypatch.setattr(lj_scale_run_torch, "CACHE_ROOT", str(tmp_path))
    lj_scale_run.main(["lj_scale_run.py", "prep", "12", "8"])
    capsys.readouterr()
    jax_ab = load("scripts/quality_ab.py", "quality_ab_jax")
    port_ab = load("scripts/quality_ab_torch.py", "quality_ab_port")
    jax_ab.main(["x", "12", "8"])
    want = json_lines(capsys.readouterr().out)
    out = tmp_path / "ab.jsonl"
    port_ab.main(["x", "12", "8", "--out", str(out)])
    got = json_lines(capsys.readouterr().out)
    assert len(got) == len(want) == 1
    assert set(got[0]) == set(want[0])
    for key in want[0]:
        if key != "greedy_seconds":
            assert got[0][key] == want[0][key], key
    assert [json.loads(ln) for ln in out.read_text().splitlines()] == got


def test_planted_precision_matches_jax(tmp_path, capsys):
    """40 communities of 250 at the roster's p_in and p_out, uncapped and
    capped at 240 original vertices (where the cap binds): level sizes,
    truth level and similarity equal, Q within Q_TOL."""
    jax_pp = load("scripts/planted_precision.py", "planted_precision_jax")
    port_pp = load("scripts/planted_precision_torch.py",
                   "planted_precision_port")
    args = ["--caps", "0,240", "--k", "40", "--m", "250"]
    jax_pp.main(["-o", str(tmp_path / "jax.jsonl")] + args)
    want = [json.loads(ln) for ln in
            (tmp_path / "jax.jsonl").read_text().splitlines()]
    port_pp.main(["-o", str(tmp_path / "port.jsonl"), "--device", "cpu"]
                 + args)
    got = [json.loads(ln) for ln in
           (tmp_path / "port.jsonl").read_text().splitlines()]
    assert json_lines(capsys.readouterr().out)[-2:] == got
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert_records_equal(g, w)
    # the cap binds here: the two hierarchies differ
    assert got[0]["level_sizes"] != got[1]["level_sizes"]


NEW_DRIVERS = ["halo_pipeline_run_torch", "halo_scale_run_torch",
               "lj_step_probe_torch", "dist_halo_record_torch",
               "quality_roster_torch", "quality_ab_torch",
               "planted_precision_torch"]


def committed_files():
    """The repo's files as git lists them, or those on disk where the
    checkout has no git."""
    proc = subprocess.run(["git", "ls-files"], cwd=REPO,
                          capture_output=True, text=True)
    if proc.returncode == 0 and proc.stdout:
        return set(proc.stdout.split())
    return {os.path.relpath(os.path.join(d, f), REPO)
            for d, _, fs in os.walk(REPO) for f in fs}


def test_default_outputs_name_no_committed_file():
    """No default output of a new driver names a committed file (the JAX
    records), nor any JAX script's default output."""
    committed = committed_files()
    jax_defaults = {os.path.basename(load(f"scripts/{s}.py", s + "_d").OUT)
                    for s in ("lj_step_probe", "dist_halo_record")}
    jax_defaults |= {"bench_planted_precision.jsonl", "bench_quality.jsonl"}
    assert {"BENCH_LJ.jsonl", "dist_halo_record.jsonl"} <= committed
    for name in NEW_DRIVERS:
        out = load(f"scripts/{name}.py", name + "_defaults").OUT
        assert os.path.basename(out) == out and "_torch" in out, name
        assert out not in committed, name
        assert out not in jax_defaults, name
