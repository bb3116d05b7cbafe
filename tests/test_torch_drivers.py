"""The port's run drivers against the JAX package's, on the CPU.

``scripts/lj_scale_run_torch.py``, ``examples/staged_configs_torch.py`` and
``examples/quickstart_torch.py`` beside ``scripts/lj_scale_run.py``,
``examples/staged_configs.py`` and ``examples/quickstart.py``, each loaded
from its path, on the same inputs at a small size.  Every cache, store and
plot goes to the test's tmp directory.

Tolerance: the prep caches (every array, its dtype, the level sizes and
entries, the rounded modularity) are equal bit for bit; so are the record
keys n, edges and levels.  The modularities are float32 sums in another
order and agree within 1e-6.  The embed stage's layout stress on the
JAX-written rmat(12, 8) cache is within 5% of the JAX script's (the random
streams differ, threefry against Philox; measured 0.2447 against 0.2457);
its coordinates lie inside their parent balls within the float32 slack of
the centres' magnitude.
"""

import importlib.util
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_thread():
    """The port's CPU loops are thousands of small ops: under the suite's
    parallel workers, torch's intra-op threads wait on each other for
    longer than the ops take, so these tests run them on one thread."""
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


@pytest.fixture
def lj(tmp_path, monkeypatch):
    """(JAX script, port script), both caching under tmp_path, the synthetic
    graph caches there too, the working directory tmp_path."""
    from graph_embed_tpu_torch.graph import synth as psynth

    monkeypatch.chdir(tmp_path)
    # the JAX synth cache lives under ~/.cache, the port's in its build dir
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setattr(psynth, "_CACHE_DIR", str(tmp_path / "synth"))
    monkeypatch.delenv("LJ_X_PRECISION", raising=False)
    jax_run = load("scripts/lj_scale_run.py", "lj_scale_run_jax")
    port_run = load("scripts/lj_scale_run_torch.py", "lj_scale_run_port")
    monkeypatch.setattr(jax_run, "CACHE_ROOT", str(tmp_path / "jax"))
    monkeypatch.setattr(port_run, "CACHE_ROOT", str(tmp_path / "torch"))
    return jax_run, port_run


def json_lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


PREP_KEYS = ("n", "edges", "level_sizes", "modularity", "level_edges")


@pytest.mark.parametrize("scale,ef", [(12, 8), ("mesh", 12)])
def test_prep_cache_equals_jax(lj, scale, ef):
    jax_run, port_run = lj
    want, got = {}, {}
    jax_run.prep(scale, ef, want)
    port_run.prep(scale, ef, got)
    for key in PREP_KEYS:
        assert got[key] == want[key], key
    jdir, pdir = jax_run.cache_dir(scale, ef), port_run.cache_dir(scale, ef)
    with open(os.path.join(pdir, "prep.json")) as f:
        got_json = json.load(f)
    with open(os.path.join(jdir, "prep.json")) as f:
        want_json = json.load(f)
    assert set(got_json) == set(want_json)
    assert {k: got_json[k] for k in PREP_KEYS} == {
        k: want_json[k] for k in PREP_KEYS}
    names = [f"graph{l}.npz" for l in range(len(want["level_sizes"]))]
    for name in names + ["parts.npz"]:
        zj, zp = np.load(os.path.join(jdir, name)), np.load(
            os.path.join(pdir, name))
        assert sorted(zp.files) == sorted(zj.files), name
        for key in zj.files:
            assert zp[key].dtype == zj[key].dtype, (name, key)
            np.testing.assert_array_equal(zp[key], zj[key], err_msg=name)
    # a second prep reads the cache back
    again = {}
    port_run.prep(scale, ef, again)
    assert again == got


def test_prep_rebuilds_unit_weights(lj):
    """rmat's generator counts duplicate draws in its weights; the prep
    rebuilds the graph with unit weights, as the JAX script does."""
    import graph_embed_tpu_torch as gp

    _, port_run = lj
    counted = gp.synth.rmat(12, 8, seed=1)
    assert float(counted.weights.max()) > 1.0
    rec = {}
    port_run.prep(12, 8, rec)
    z = np.load(os.path.join(port_run.cache_dir(12, 8), "graph0.npz"))
    assert z["s"].size == counted.num_edges
    assert (z["w"] == 1.0).all()


def test_embed_stage_on_the_jax_cache(lj, capsys):
    """The port's embed stage runs on the cache the JAX script wrote (the
    same format); a rerun resumes from the checkpoint store and equals the
    first run."""
    jax_run, port_run = lj
    port_run.CACHE_ROOT = jax_run.CACHE_ROOT
    rec_j = {}
    jax_run.prep(12, 8, rec_j)
    jax_run.run_embed(12, 8, rec_j)
    capsys.readouterr()
    # the JAX script's store has the port's format: start the port afresh
    ckpt = os.path.join(port_run.cache_dir(12, 8), "ckpt")
    shutil.rmtree(ckpt)
    rec = {"workload": "rmat(12,8)"}
    coords = port_run.run_embed(12, 8, rec, torch.device("cpu"))
    lines = json_lines(capsys.readouterr().out)
    assert lines[-1] == rec
    assert set(rec) == set(rec_j) | {"workload"}
    for key in PREP_KEYS + ("base_iterations",):
        assert rec[key] == rec_j[key], key
    assert rec["coords_finite"] and np.isfinite(coords).all()
    assert coords.shape == (rec["n"], 3)
    assert rec["stress"] == pytest.approx(rec_j["stress"], rel=0.05)
    balls = [ln for ln in lines if ln.get("phase") == "balls"][0]["levels"]
    assert sorted(balls) == ["0", "1"]
    for lvl in balls.values():
        assert lvl["finite"] and lvl["excess"] <= lvl["slack"]
    spans = [ln["span"] for ln in lines if ln.get("phase") == "span"]
    assert spans == ["base", "radii", "layout", "refine", "radii", "layout",
                     "refine"]
    buckets = [ln for ln in lines if ln.get("phase") == "buckets"]
    assert [b["level"] for b in buckets] == [0, 1]
    assert buckets[0]["slots"] >= rec["n"]

    # drop level 0 from the manifest: the rerun refines level 0 again from
    # the stored level 1, with the same per-level seed
    with open(os.path.join(ckpt, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["completed"] == [0, 1, 2]
    with open(os.path.join(ckpt, "manifest.json"), "w") as f:
        json.dump({"completed": [1, 2]}, f)
    again = port_run.run_embed(12, 8, {"workload": "rmat(12,8)"},
                               torch.device("cpu"))
    spans = [ln["span"] for ln in json_lines(capsys.readouterr().out)
             if ln.get("phase") == "span"]
    assert spans == ["resume", "radii", "layout", "refine"]
    np.testing.assert_array_equal(again, coords)
    # everything stored: the rerun loads level 0 itself
    third = port_run.run_embed(12, 8, {"workload": "rmat(12,8)"},
                               torch.device("cpu"))
    np.testing.assert_array_equal(third, coords)


def test_refine0_stage_runs(lj, capsys):
    _, port_run = lj
    port_run.prep(12, 8, {})
    port_run.probe_refine0(12, 8, torch.device("cpu"))
    err = capsys.readouterr().err
    assert "prepare_refine:" in err and "kind=exact" in err
    assert err.count("refine iters=") == 4


@pytest.fixture
def small_coolist(tmp_path):
    """A 600-vertex power-law edge list in coolist form (``s r w``)."""
    rng = np.random.default_rng(7)
    n = 600
    s = (rng.random(3000) ** 2 * n).astype(np.int64)
    r = rng.integers(0, n, 3000)
    keep = s != r
    path = tmp_path / "small.coo"
    path.write_text("".join(f"{a} {b} 1\n" for a, b in zip(s[keep],
                                                            r[keep])))
    return str(path)


@pytest.fixture(scope="module")
def staged():
    return (load("examples/staged_configs.py", "staged_configs_jax"),
            load("examples/staged_configs_torch.py", "staged_configs_port"))


@pytest.mark.parametrize("which", [1, 2, 3, 4])
def test_staged_config_records_match_jax(staged, small_coolist, which):
    jax_cfg, port_cfg = staged
    fn_j = getattr(jax_cfg, f"config{which}")
    fn_p = getattr(port_cfg, f"config{which}")
    cpu = torch.device("cpu")
    if which == 1:
        want, got = fn_j(), fn_p(cpu)
    elif which == 4:
        want, got = fn_j(small_coolist), fn_p(cpu, small_coolist, shards=2)
        assert got["devices"] == 2
    else:
        want, got = fn_j(small_coolist), fn_p(cpu, small_coolist)
    assert set(got) == set(want)
    assert got["finite"] is True and want["finite"] is True
    for key in ("config", "n", "edges", "levels"):
        assert got.get(key) == want.get(key), key
    if which == 2:
        assert got["modularity_l1"] == pytest.approx(want["modularity_l1"],
                                                     abs=1e-6)


def test_quickstart_record_matches_jax(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    jax_qs = load("examples/quickstart.py", "quickstart_jax")
    port_qs = load("examples/quickstart_torch.py", "quickstart_port")
    monkeypatch.setattr(sys, "argv", ["quickstart.py", "jax.html"])
    jax_qs.main()
    want = json_lines(capsys.readouterr().out)[-1]
    port_qs.main(["quickstart_torch.py", "port.html", "--device", "cpu"])
    got = json_lines(capsys.readouterr().out)[-1]
    assert set(got) == set(want) | {"finite"}
    assert got["finite"] is True
    for key in ("n", "edges", "levels"):
        assert got[key] == want[key], key
    assert got["modularity_l1"] == pytest.approx(want["modularity_l1"],
                                                 abs=1e-6)
    assert np.isfinite(got["stress"])
    assert (tmp_path / "port.html").stat().st_size > 0


def test_drivers_raise_without_a_card(monkeypatch, small_coolist):
    """The drivers default to the card and raise where there is none; they
    never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lj_port = load("scripts/lj_scale_run_torch.py", "lj_scale_run_nocard")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lj_port.main(["lj_scale_run_torch.py", "prep", "10", "8"])
    staged = load("examples/staged_configs_torch.py", "staged_nocard")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        staged.main(["staged_configs_torch.py", "3", small_coolist])
    qs = load("examples/quickstart_torch.py", "quickstart_nocard")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        qs.main(["quickstart_torch.py", "q.html"])


IMPORT_CHECK = r"""
import json, runpy, sys
before = set(sys.modules)
import torch
torch.set_num_threads(1)
root, tmp, coo = sys.argv[1:4]
sys.path.insert(0, root)
from graph_embed_tpu_torch.graph import synth
synth._CACHE_DIR = tmp + "/synth"
lj = runpy.run_path(root + "/scripts/lj_scale_run_torch.py", run_name="lj")
lj["main"].__globals__["CACHE_ROOT"] = tmp + "/lj"
lj["main"](["lj", "prep", "10", "8", "--device", "cpu"])
staged = runpy.run_path(root + "/examples/staged_configs_torch.py",
                        run_name="staged")
staged["main"](["staged", "3", coo, "--device", "cpu"])
qs = runpy.run_path(root + "/examples/quickstart_torch.py", run_name="qs")
qs["main"](["qs", tmp + "/q.html", "--device", "cpu"])
# the seven drivers of the halo pipeline, the probes, the two-process
# record and the quality tools read the same cache through this module
sys.path.insert(0, root + "/scripts")
import lj_scale_run_torch
lj_scale_run_torch.CACHE_ROOT = tmp + "/lj"
cpu = ["--device", "cpu"]


def run(name, argv, **env):
    mod = runpy.run_path(root + "/scripts/" + name + ".py", run_name=name)
    mod["main"].__globals__.update(env)
    assert mod["main"](argv) in (0, None), name


run("halo_pipeline_run_torch", ["hp", "2", "20", "10", "8", "both", *cpu,
                                "--out", tmp + "/hp.jsonl"])
run("halo_scale_run_torch", ["hs", "10", "8", *cpu, "--out",
                             tmp + "/hs.jsonl"])
run("lj_step_probe_torch", ["ls", "10", "8", "1024", "2048", *cpu, "--out",
                            tmp + "/ls.jsonl"])
run("quality_ab_torch", ["qa", "10", "8", "--out", tmp + "/qa.jsonl"])
run("quality_roster_torch", ["--cpu", "--louvain-max-n", "0", "-o",
                             tmp + "/qr.jsonl"],
    ROSTER=["synth:planted:4:30:0.3:0.01"])
run("planted_precision_torch", ["-o", tmp + "/pp.jsonl", "--caps", "0,40",
                                "--k", "4", "--m", "30", *cpu])
import os
os.environ["DIST_HALO_SCALE"] = "8"
run("_dist_halo_worker_torch", ["w", "0", "1", "unused", tmp + "/dw.jsonl",
                                *cpu])
run("dist_halo_record_torch", ["dh", "8", *cpu, "--out", tmp + "/dh.jsonl"],
    CACHE_ROOT=tmp + "/dist")
print(json.dumps(sorted(m for m in set(sys.modules) - before
                        if m in ("jax", "graph_embed_tpu")
                        or m.startswith(("jax.", "graph_embed_tpu.")))))
"""


def test_drivers_import_no_jax(tmp_path, small_coolist):
    """Each driver runs a small stage on the CPU in a fresh interpreter
    (the seven of the halo pipeline, the probes, the two-process record
    and the quality tools on the lj cache it leaves, the worker of the
    two-process record in-process); none of them imports jax or the JAX
    package."""
    proc = subprocess.run(
        [sys.executable, "-c", IMPORT_CHECK, REPO, str(tmp_path),
         small_coolist], capture_output=True, text=True,
        cwd=str(tmp_path), timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.splitlines()[-1]) == []
