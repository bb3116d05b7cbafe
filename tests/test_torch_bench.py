"""bench_torch.py, the port of bench.py, on the CPU at small sizes.

The unit-weight rebuild of the scattered workload gives the JAX recipe's
COO exactly (bench.py:66-70); the port's timed loop equals bench.py's loop
body (``key, sub = split(key)``, then ``fa_step_tiled_T``, the Pallas
kernels in interpret mode) on the ids the reference draws, to 1e-4 as
tests/test_torch_tiled.py holds the tiled loop; ``bench_fa`` gives the
child's record on the CPU; the parent's headline, failure and exit rules
hold with ``run_child`` replaced; and the program imports no JAX and
raises without a card unless the CPU is asked for.
"""

import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graph_embed_tpu as gt
from graph_embed_tpu.forceatlas import tiled as JTL
from graph_embed_tpu.graph import synth as jsynth
from graph_embed_tpu.ops.pallas import edge_spmm as JES
from graph_embed_tpu.utils.params import ForceAtlasParams as JParams

from graph_embed_tpu_torch import interop
from graph_embed_tpu_torch.forceatlas import tiled as PTL
from graph_embed_tpu_torch.graph import synth as psynth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S = 64  # bench.py's num_samples


def _load():
    spec = importlib.util.spec_from_file_location(
        "bench_torch", os.path.join(REPO, "bench_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


BT = _load()


def _jax_unit(g):
    """bench.py's rebuild (bench.py:66-70) in the JAX package."""
    s, r, _ = g.to_coo_numpy()
    return gt.from_edges(s, r, np.ones(s.size, np.float32), n=g.n,
                         symmetrize=False)


def _ids(key, s, n):
    """The sample ids the reference draws from ``key`` (prep_samples,
    repulsion.py:132), for the port to take."""
    return torch.from_numpy(np.asarray(
        jax.random.randint(key, (s,), 0, n)).astype(np.int32))


def _same_coo(gp, gj):
    for got, want in zip(gp.to_coo_numpy(), gj.to_coo_numpy()):
        np.testing.assert_array_equal(got, want)


def test_unit_weights_match_jax_recipe():
    """rmat(12, 8, seed=1) rebuilt with unit weights: the same n, stored
    entries and COO as bench.py's recipe, every weight 1 (rmat's own
    weights count duplicate draws); mesh3d(8) is the same in both."""
    raw = psynth.rmat(12, 8, seed=1)
    assert raw.weights.max() > 1.0   # the trap the rebuild removes
    gp = BT.unit_weights(raw)
    gj = _jax_unit(jsynth.rmat(12, 8, seed=1))
    assert (gp.n, gp.num_edges) == (gj.n, gj.num_edges)
    _same_coo(gp, gj)
    assert bool((gp.weights == 1.0).all())
    mp, mj = psynth.mesh3d(8), jsynth.mesh3d(8)
    assert (mp.n, mp.num_edges) == (mj.n, mj.num_edges) == (512, 2688)
    _same_coo(mp, mj)


# (port graph, JAX graph, prepare_tiled keywords, launches per iteration).
# The mesh is pure DIA, as mesh3d(128) is at the default threshold; the
# rmat keeps bench.py's shape ratios scaled down (B = W, T = W / 2 here),
# and 'packed' keeps it on the windowed residual that rmat(20, 8) takes
# under 'auto' (at this size 'auto' would densify it into BSR blocks).
CASES = {
    "mesh": (lambda: psynth.mesh3d(8), lambda: jsynth.mesh3d(8),
             dict(dia_min_count=32), {"fused_step": 1}),
    "scattered": (lambda: BT.unit_weights(psynth.rmat(10, 8, seed=1)),
                  lambda: _jax_unit(jsynth.rmat(10, 8, seed=1)),
                  dict(spmv_mode="packed", sender_block=256, window=256,
                       tile=128),
                  {"edge_spmm[unit]": 1, "fused_step": 1}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_matches_bench_loop(case):
    """Five iterations of bench.py's loop body against the port's ``run``
    on the same graph and the ids the reference draws from each split key,
    to rtol = atol = 1e-4 (test_tiled_step.py:40; the reference's residual
    SpMV carries a ~2^-16 relative bf16 hi/lo error): coordinates element
    by element, f relative to its largest entry (tests/test_torch_tiled.py).
    Each iteration starts from the reference's state: chained, each step's
    float32 rounding (~1e-5 here) grows past 1e-4 within five steps, as
    flat FA amplifies it (ROADMAP queue 3), so the five-iteration loop is
    held bit for bit to the port's steps in turn."""
    make_p, make_j, kw, launches = CASES[case]
    gp, gj = make_p(), make_j()
    _same_coo(gp, gj)
    params = BT.bench_params(S)
    jparams = JParams(repulsion="sampled", num_negative_samples=S)
    tfa_j = JTL.prepare_tiled(gj, 3, jparams, interpret=True, **kw)
    tfa = PTL.prepare_tiled(gp, 3, params, **kw)
    assert BT.expected_launches(tfa) == launches
    assert tfa.dia_offsets == tuple(tfa_j.dia_offsets)
    x0 = np.random.default_rng(7).uniform(-1, 1, (gp.n, 3)).astype(
        np.float32)
    c = JES.pad_coords_T(jnp.asarray(x0), tfa_j.n_pad)
    f = jnp.zeros_like(c)
    key = jax.random.PRNGKey(0)
    ids = []
    for _ in range(5):
        key, sub = jax.random.split(key)
        ids.append(_ids(sub, S, gp.n))
        x_in = torch.from_numpy(interop.from_transposed(c, gp.n, 3).copy())
        f_in = torch.from_numpy(interop.from_transposed(f, gp.n, 3).copy())
        c, f = JTL.fa_step_tiled_T(c, f, tfa_j, jparams, sub)
        x, fp, chk = BT.run(x_in, f_in, tfa, params, 1, sample_ids=ids[-1:])
        np.testing.assert_allclose(
            x.numpy(), interop.from_transposed(c, gp.n, 3), rtol=1e-4,
            atol=1e-4)
        want_f = interop.from_transposed(f, gp.n, 3)
        assert np.abs(fp.numpy() - want_f).max() \
            <= 1e-4 * np.abs(want_f).max()
        assert float(chk) == float(x.sum())
    x, fp = torch.from_numpy(x0), torch.zeros(gp.n, 3)
    for idx in ids:
        x, fp = PTL.fa_step_tiled(x, fp, tfa, params, sample_idx=idx)
    got_x, got_f, _ = BT.run(torch.from_numpy(x0), torch.zeros(gp.n, 3), tfa,
                             params, 5, sample_ids=ids)
    assert torch.equal(got_x, x) and torch.equal(got_f, fp)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bench_fa_on_cpu(monkeypatch, case):
    """The child's record on the CPU (plain versions) for a small graph in
    place of the workload's: finite positive entries/s, every key, no
    card metric."""
    make_p, _, kw, _ = CASES[case]
    g = make_p()
    monkeypatch.setattr(BT, "build_graph", lambda wl, shape: (g, kw))
    rec = BT.bench_fa(case, iters_per_call=3, repeats=3, device="cpu")
    assert set(rec) == {
        "workload", "edges_per_sec", "ms_per_iteration",
        "ms_per_iteration_all", "events_ms_per_iteration",
        "card_ms_per_iteration", "enqueue_ms_per_iteration",
        "launches_per_iteration", "peak_bytes", "checksum", "iterations",
        "repeats", "n", "edges", "prepare_tiled_seconds", "device"}
    assert math.isfinite(rec["edges_per_sec"]) and rec["edges_per_sec"] > 0
    assert len(rec["ms_per_iteration_all"]) == 3
    assert (rec["n"], rec["edges"], rec["workload"]) == (g.n, g.num_edges,
                                                         case)
    assert math.isfinite(rec["checksum"]) and rec["device"] == "cpu"
    # the plain versions launch nothing; the card's numbers stay unmeasured
    assert rec["launches_per_iteration"] == {}
    assert rec["events_ms_per_iteration"] is None
    assert rec["peak_bytes"] is None
    json.dumps(rec)


def test_time_plan_needs_the_fused_step():
    """The bench times kernel D's step; a plan that cannot take it (here
    linlog) is refused."""
    g = psynth.mesh3d(4)
    lin = dataclasses.replace(BT.bench_params(S), linlog=True)
    tfa = PTL.prepare_tiled(g, 3, lin)
    with pytest.raises(ValueError, match="fused step"):
        BT.time_plan(g, tfa, lin, iters_per_call=1, repeats=1)


def _record(value):
    return {"workload": "w", "edges_per_sec": value, "n": 10, "edges": 40,
            "events_ms_per_iteration": 0.25, "enqueue_ms_per_iteration": 0.3,
            "launches_per_iteration": {"fused_step": 1},
            "device": "NVIDIA H100 80GB HBM3, 700.00 W"}


@pytest.mark.parametrize("outcome,rc,headline,value", [
    ({"mesh": 9e10, "scattered": 6e10}, 0, "scattered", 6e10),
    ({"mesh": 5e10, "scattered": 7e10}, 0, "mesh", 5e10),
    ({"mesh": None, "scattered": 6e10}, 1, "mesh", 0.0),
    ({"mesh": 9e10, "scattered": None}, 1, "scattered", 0.0),
    ({"mesh": None, "scattered": None}, 1, None, 0.0),
])
def test_main_headline_and_failures(monkeypatch, capsys, outcome, rc,
                                    headline, value):
    """The worse workload is the headline; a failed one pins it to 0 and
    gives rc 1; two failures print the error line; no vs_baseline."""
    calls = []

    def fake(wl, device="cuda"):
        calls.append((wl, device))
        v = outcome[wl]
        return None if v is None else _record(v)

    monkeypatch.setattr(BT, "run_child", fake)
    assert BT.main(["--device", "cpu"]) == rc
    assert calls == [("mesh", "cpu"), ("scattered", "cpu")]
    out = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert out["metric"] == "fa_edges_per_sec_per_chip"
    assert out["unit"] == "edges/s" and out["value"] == value
    assert "vs_baseline" not in json.dumps(out)
    failed = [wl for wl, v in outcome.items() if v is None]
    assert out.get("failed_workloads", []) == failed
    for wl in failed:
        assert out["workloads"][wl] == {"value": 0.0, "error":
                                         "workload failed or timed out"}
    if headline is None:
        assert out["error"] == "all workloads failed"
        assert "headline_workload" not in out
        return
    assert out["headline_workload"] == headline
    assert out["device"] == {"name": "NVIDIA H100 80GB HBM3",
                             "power_limit": "700.00 W"}
    for wl, v in outcome.items():
        if v is not None:
            assert out["workloads"][wl]["value"] == v
            assert out["workloads"][wl]["events_ms_per_iteration"] == 0.25


def test_shape_applies_to_scattered_only():
    """--shape on the mesh workload raises bench.py's ValueError (before
    any graph is built); the parent takes no --shape."""
    with pytest.raises(ValueError, match="only applies to --workload "
                                         "scattered"):
        BT.build_graph("mesh", (256, 256, 128))
    with pytest.raises(ValueError, match="only applies"):
        BT.main(["--workload", "mesh", "--shape", "256,256,128",
                 "--device", "cpu"])
    with pytest.raises(SystemExit):
        BT.main(["--shape", "256,256,128"])
    with pytest.raises(SystemExit):
        BT.main(["--workload", "scattered", "--shape", "256,256"])


IMPORT_CHECK = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import bench_torch as BT
from graph_embed_tpu_torch.graph import synth
g = synth.mesh3d(4)
BT.build_graph = lambda wl, shape: (g, dict(dia_min_count=8))
rec = BT.bench_fa("mesh", iters_per_call=2, repeats=1, device="cpu")
assert rec["edges_per_sec"] > 0
print(json.dumps(sorted(m for m in sys.modules
                        if m in ("jax", "graph_embed_tpu", "bench")
                        or m.startswith(("jax.", "graph_embed_tpu.")))))
"""


def test_import_leaves_jax_out():
    """In a fresh interpreter, importing bench_torch and running a small
    bench on the CPU imports neither jax, the JAX package nor bench.py."""
    proc = subprocess.run([sys.executable, "-c", IMPORT_CHECK, REPO],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.splitlines()[-1]) == []


def test_default_device_needs_a_card():
    """Without a card the default device raises (no CPU fallback), and the
    whole program prints value 0 with both workloads failed and exits
    1."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BT.bench_fa("mesh")
    proc = subprocess.run([sys.executable, os.path.join(REPO,
                                                        "bench_torch.py")],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1
    out = json.loads(proc.stdout.splitlines()[-1])
    assert out["value"] == 0.0
    assert out["failed_workloads"] == ["mesh", "scattered"]
    assert "no CUDA device" in proc.stderr
