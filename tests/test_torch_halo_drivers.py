"""The port's halo and LiveJournal-scale step drivers against the JAX
package's, on the CPU.

``scripts/halo_pipeline_run_torch.py``, ``scripts/halo_scale_run_torch.py``,
``scripts/lj_step_probe_torch.py`` and ``scripts/dist_halo_record_torch.py``
beside their JAX scripts, each loaded from its path, on the rmat(12, 8)
prep cache the JAX script ``lj_scale_run.py`` wrote (the port reads the
same format), or at rmat(10, 8).  Every cache, store and record goes to
the test's tmp directory.

Tolerance: host facts are equal bit for bit (level sizes and entries, the
halo pipeline's ``base_order`` against the JAX ``partition_order``, the
8-shard halo plan's boundary fraction and comm floats, the probe's
unit-weight graph, the two-process record's n, edges, levels and comm
model, and its checksum at 1 x 8 against 2 x 4).  The pipeline's layout
stress, after 50 base iterations, is within 5% of the JAX script's (the
random streams differ, threefry against Philox; measured 0.2272 and
0.2297 against 0.2293); every refined vertex lies inside its parent ball
within the float32 slack of the centres' magnitude.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

# the pipeline's base iterations here (1,000 at LiveJournal scale)
BASE_ITERS = 50
STRESS_REL = 0.05


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


def json_lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    """The rmat(12, 8) prep cache as the JAX script writes it; its root."""
    root = tmp_path_factory.mktemp("lj_cache")
    jax_lj = load("scripts/lj_scale_run.py", "lj_scale_run_jax_halo")
    jax_lj.CACHE_ROOT = str(root)
    jax_lj.main(["lj_scale_run.py", "prep", "12", "8"])
    return root


@pytest.fixture
def drivers(cache, tmp_path, monkeypatch):
    """(the JAX lj_scale_run module, the port's sibling module), both
    reading ``cache``; the working directory tmp_path."""
    import lj_scale_run
    import lj_scale_run_torch

    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("LJ_X_PRECISION", raising=False)
    monkeypatch.delenv("HALO_SCALE_REP_ONLY", raising=False)
    monkeypatch.setattr(lj_scale_run, "CACHE_ROOT", str(cache))
    monkeypatch.setattr(lj_scale_run_torch, "CACHE_ROOT", str(cache))
    return lj_scale_run, lj_scale_run_torch


def test_halo_pipeline_matches_jax(drivers, tmp_path, monkeypatch, capsys):
    """Both arms of the truncated pipeline at rmat(12, 8): the record's
    host facts equal the JAX script's, base_order equals the JAX
    partition_order of the dropped levels, the coordinates lie finite
    inside their parent balls, the stress is the JAX script's within
    STRESS_REL, and a rerun resumes from the store and equals the first
    run."""
    import shutil

    import graph_embed_tpu_torch as gp
    from graph_embed_tpu.graph.reorder import partition_order

    jax_lj, port_lj = drivers
    jax_pipe = load("scripts/halo_pipeline_run.py", "halo_pipeline_jax")
    port_pipe = load("scripts/halo_pipeline_run_torch.py",
                     "halo_pipeline_port")
    argv = ["x", "2", str(BASE_ITERS), "12", "8", "both"]
    jax_pipe.main(argv)
    want = json_lines(capsys.readouterr().out)[-1]
    # the JAX script's stores have the port's format: start afresh
    d = port_lj.cache_dir(12, 8)
    for arm in ("halo", "replicated"):
        shutil.rmtree(os.path.join(d, f"ckpt_pipe_{arm}_2"))

    seen = {}
    embed = gp.embed

    def spy(graphs, parts, dim, **kw):
        out = embed(graphs, parts, dim, **kw)
        seen[kw["sharding"]] = (kw["base_order"], out.clone())
        return out

    monkeypatch.setattr(gp, "embed", spy)
    # launches counted before the run (as by an earlier arm) stay out of
    # its spans: on the CPU every span launches nothing
    from graph_embed_tpu_torch.ops import cuda

    monkeypatch.setitem(cuda.LAUNCHES, "edge_spmm[weighted]", 3)
    out = tmp_path / "pipe.jsonl"
    port_pipe.main(argv + ["--device", "cpu", "--out", str(out)])
    lines = json_lines(capsys.readouterr().out)
    assert all(ln["launches"] == {} for ln in lines
               if ln.get("phase") in ("span", "memory"))
    got = lines[-1]
    assert json.loads(out.read_text().splitlines()[-1]) == got
    assert got["device"] == "cpu"
    assert set(got) == set(want) | {"device"}
    for key in ("workload", "levels_kept", "level_sizes", "level_edges"):
        assert got[key] == want[key], key
    assert got["level_sizes"] == [2967, 59]

    graphs_j, parts_j, _ = jax_lj.load_cache(12, 8)
    order_j = partition_order(graphs_j[1], levels=parts_j[1:])
    assert seen["replicated"][0] is None
    np.testing.assert_array_equal(seen["halo"][0], order_j)

    for arm in ("halo", "replicated"):
        g_arm, w_arm = got[arm], want[arm]
        assert set(g_arm) == set(w_arm) | {"base_repulsion"}
        for key in ("sharding", "levels", "base_n", "base_edges",
                    "base_iterations", "mesh_min_n", "coords_finite"):
            assert g_arm[key] == w_arm[key], (arm, key)
        assert g_arm["stress"] == pytest.approx(w_arm["stress"],
                                                rel=STRESS_REL)
        assert torch.isfinite(seen[arm][1]).all()
        balls = [ln for ln in lines if ln.get("phase") == "balls"
                 and ln["arm"] == arm][0]["levels"]
        assert sorted(balls) == ["0"]
        assert balls["0"]["finite"]
        assert balls["0"]["excess"] <= balls["0"]["slack"]
        spans = [ln["span"] for ln in lines if ln.get("phase") == "span"
                 and ln["arm"] == arm]
        assert spans == ["base", "radii", "layout", "refine"]
        refine = [ln for ln in lines if ln.get("phase") == "span"
                  and ln["arm"] == arm and ln["span"] == "refine"][0]
        assert refine["route"] == "sharded"
    # 59 vertices: the replicated base case keeps the dense gram
    # repulsion; the halo step runs the sampled estimator
    assert got["halo"]["base_repulsion"] == "sampled"
    assert got["replicated"]["base_repulsion"] == "gram"

    # drop level 0 from the halo arm's manifest: the rerun refines level 0
    # again from the stored base level, with the same per-level seed
    ckpt = os.path.join(d, "ckpt_pipe_halo_2")
    with open(os.path.join(ckpt, "manifest.json")) as f:
        assert json.load(f)["completed"] == [0, 1]
    with open(os.path.join(ckpt, "manifest.json"), "w") as f:
        json.dump({"completed": [1]}, f)
    first = seen.pop("halo")[1]
    port_pipe.main(["x", "2", str(BASE_ITERS), "12", "8", "halo",
                    "--device", "cpu", "--out", str(out)])
    lines = json_lines(capsys.readouterr().out)
    assert [ln["span"] for ln in lines if ln.get("phase") == "span"] == [
        "resume", "radii", "layout", "refine"]
    assert torch.equal(seen["halo"][1], first)
    assert lines[-1]["halo"]["stress"] == got["halo"]["stress"]


def jax_plan8(jax_lj):
    """The JAX package's 8-shard halo plan on the hierarchy-ordered
    rmat(12, 8) of the cache."""
    from graph_embed_tpu.graph.reorder import apply_order, partition_order
    from graph_embed_tpu.parallel.halo import build_halo_plan

    graphs, parts, _ = jax_lj.load_cache(12, 8)
    g_ord, _ = apply_order(graphs[0], partition_order(graphs[0],
                                                       levels=parts))
    return build_halo_plan(g_ord, 8)


def test_halo_scale_matches_jax_plan(drivers, tmp_path, monkeypatch,
                                     capsys):
    """The 8-shard plan fields equal the JAX build_halo_plan's; the
    optional ``B W`` reach prepare_tiled (and only it); both steps run
    and are timed; HALO_SCALE_REP_ONLY skips the halo step."""
    from graph_embed_tpu_torch.forceatlas import tiled as TL

    jax_lj, _ = drivers
    scale = load("scripts/halo_scale_run_torch.py", "halo_scale_port")
    plan = jax_plan8(jax_lj)
    calls = []
    prepare = TL.prepare_tiled

    def spy(g, dim, params, **kw):
        calls.append(kw)
        return prepare(g, dim, params, **kw)

    monkeypatch.setattr(TL, "prepare_tiled", spy)
    out = tmp_path / "scale.jsonl"
    scale.main(["x", "12", "8", "256", "512", "--device", "cpu", "--out",
                str(out)])
    rec = json_lines(capsys.readouterr().out)[-1]
    assert json.loads(out.read_text().splitlines()[-1]) == rec
    assert (rec["n"], rec["edges"]) == (2967, 53206)
    assert rec["plan8_boundary_fraction"] == round(plan.boundary_fraction,
                                                   4)
    assert rec["plan8_comm_floats_per_step"] == plan.comm_floats_per_step(
        3, 64)
    assert rec["plan8_replicated_comm_floats"] == 2 * 8 * plan.blk * 3
    assert calls == [dict(sender_block=256, window=512, tile=1024)]
    assert rec["shape"] == [256, 512]
    assert rec["tiles_entries"] == 53206 and not rec["tiles_weighted"]
    for key in ("halo_ms_per_iter", "replicated_ms_per_iter",
                "halo_edges_per_sec", "replicated_edges_per_sec",
                "halo_vs_replicated"):
        assert np.isfinite(rec[key]) and rec[key] > 0, key
    assert rec["device"] == "cpu"

    monkeypatch.setenv("HALO_SCALE_REP_ONLY", "1")
    scale.main(["x", "12", "8", "--device", "cpu", "--out", str(out)])
    rec = json_lines(capsys.readouterr().out)[-1]
    assert calls[-1] == {}
    assert "halo_ms_per_iter" not in rec and "replicated_ms_per_iter" in rec


def test_lj_step_probe_graph_matches_jax(drivers, tmp_path, capsys):
    """The probe's graph is the JAX probe's: the cached fine graph in
    hierarchy order, rebuilt with unit weights (the same COO); its record
    lands in ``--out``."""
    import graph_embed_tpu as gt
    from graph_embed_tpu.graph.reorder import partition_order

    jax_lj, _ = drivers
    probe = load("scripts/lj_step_probe_torch.py", "lj_step_probe_port")
    graphs, parts, _ = jax_lj.load_cache(12, 8)
    g0 = graphs[0]
    perm = partition_order(g0, levels=parts)
    s0, r0, _ = g0.to_coo_numpy()
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    want = gt.from_edges(inv[s0], inv[r0], np.ones(s0.size, np.float32),
                         n=g0.n, symmetrize=False)
    got, workload = probe.probe_graph(12, 8)
    assert workload == "rmat(12,8) ordered full step"
    for a, b in zip(got.to_coo_numpy(), want.to_coo_numpy()):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    out = tmp_path / "BENCH_LJ_torch.jsonl"
    for _ in range(2):
        probe.main(["x", "12", "8", "1024", "2048", "0", "f32", "--device",
                    "cpu", "--out", str(out)])
    rec = json_lines(capsys.readouterr().out)[-1]
    assert [json.loads(ln) for ln in out.read_text().splitlines()][-1] == rec
    assert len(out.read_text().splitlines()) == 2
    assert (rec["n"], rec["edges"]) == (want.n, want.num_edges)
    assert rec["shape"] == [1024, 2048] and rec["fused"] is True
    assert rec["residual_entries"] == want.num_edges
    assert np.isfinite(rec["ms_per_iter"]) and rec["device"] == "cpu"


def test_dist_halo_record_two_processes_equal_one(tmp_path, monkeypatch,
                                                  capsys):
    """rmat(10, 8) at 1 x 8 and at 2 x 4 under gloo on the CPU: equal
    checksums, and n, edges, levels and comm model as the JAX library
    computes them on the same graph."""
    import jax.numpy as jnp

    import graph_embed_tpu as gt
    from graph_embed_tpu.graph.reorder import apply_order, partition_order
    from graph_embed_tpu.graph.synth import rmat
    from graph_embed_tpu.parallel.halo import build_halo_plan

    dist = load("scripts/dist_halo_record_torch.py", "dist_halo_port")
    monkeypatch.setattr(dist, "CACHE_ROOT", str(tmp_path / "cache"))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = tmp_path / "dist.jsonl"
    assert dist.main(["x", "10", "--device", "cpu", "--out",
                      str(out)]) == 0
    lines = json_lines(capsys.readouterr().out)
    assert lines[-1]["checksums_equal"] is True
    recs = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert [(r["nprocs"], r["ndev_local"]) for r in recs] == [(1, 8), (2, 4)]
    assert recs[0]["coords_checksum"] == recs[1]["coords_checksum"]

    g = rmat(10, 8, seed=1, dtype=jnp.float32)
    res = gt.partition_hierarchy(g, 0.1)
    g_ord, _ = apply_order(g, partition_order(g, levels=res.levels))
    plan = build_halo_plan(g_ord, 8)
    comm = {"ndev": 8, "B_max": plan.B_max,
            "boundary_fraction": round(plan.boundary_fraction, 4),
            "halo_floats_per_step": plan.comm_floats_per_step(3, 64),
            "replicated_floats_per_step": 2 * 8 * plan.blk * 3}
    for rec in recs:
        assert (rec["n"], rec["edges"], rec["levels"]) == (
            g.n, g.num_edges, len(res.levels) + 1)
        assert rec["comm_model"] == comm
        assert rec["device"] == "cpu"
        assert np.isfinite(rec["coords_checksum"])
    spans = (tmp_path / "dist.jsonl.metrics.p0.jsonl").read_text()
    assert [json.loads(ln)["nprocs"] for ln in spans.splitlines()
            if json.loads(ln)["phase"] == "base"] == [1, 2]


def test_build_halo_csr_defaults_to_the_card(monkeypatch):
    """``build_halo_csr`` resolves its device as ``make_mesh`` does: the
    card by default, raising where there is none; the CPU only when
    asked for."""
    import inspect

    import graph_embed_tpu_torch as gp
    from graph_embed_tpu_torch.parallel import halo as PH

    default = inspect.signature(PH.build_halo_csr).parameters["device"]
    assert default.default == "cuda"
    g = gp.synth.ring_of_cliques(3, 4)
    plan = PH.build_halo_plan(g, 2)
    params = gp.ForceAtlasParams(repulsion="sampled")
    assert PH.build_halo_csr(plan, params, device="cpu").csr.indptr.device \
        == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PH.build_halo_csr(plan, params)


@pytest.mark.parametrize("sharding,dense_max,want", [
    ("halo", None, "sampled"),
    ("replicated", None, "gram"),
    ("replicated", 0, "sampled"),
])
def test_base_span_names_the_repulsion_the_step_ran(monkeypatch, sharding,
                                                     dense_max, want):
    """The base span's ``repulsion`` is the one the mesh base case was
    handed: the halo step always samples; the replicated step keeps the
    gram repulsion unless its dense block passes ``DENSE_D2_MAX_BYTES``
    (0 here forces the switch)."""
    import graph_embed_tpu_torch as gp
    from graph_embed_tpu_torch.embed import driver
    from graph_embed_tpu_torch.parallel import sharded as PSH
    from graph_embed_tpu_torch.parallel.mesh import make_mesh
    from graph_embed_tpu_torch.utils.timing import MetricsLogger

    if dense_max is not None:
        monkeypatch.setattr(PSH, "DENSE_D2_MAX_BYTES", dense_max)
    ran = []
    for name in ("halo_force_atlas", "sharded_force_atlas"):
        step = getattr(driver, name)

        def spy(*a, _step=step, **kw):
            ran.append(kw["params"].repulsion)
            return _step(*a, **kw)

        monkeypatch.setattr(driver, name, spy)
    g = gp.synth.mesh3d(6)
    res = gp.partition_hierarchy(g, 0.25, emit_graphs=True)
    metrics = MetricsLogger()
    coords = gp.embed([g] + res.coarse_graphs, res.levels, 2,
                      device="cpu", mesh=make_mesh(1, device="cpu"),
                      sharding=sharding, mesh_min_n=1, base_iterations=3,
                      refine_iterations=2, metrics=metrics)
    assert bool(torch.isfinite(coords).all())
    base = [r for r in metrics.records if r["phase"] == "base"]
    assert ran == [want] and [r["repulsion"] for r in base] == [want]


def test_device_busy_seconds_unions_the_card_intervals():
    """The pipeline's busy seconds per span: the union of the profiler's
    device intervals (µs), overlaps counted once, host events left out."""
    from types import SimpleNamespace

    from lj_scale_run_torch import device_busy_seconds
    from torch.autograd import DeviceType

    def event(kind, lo, hi):
        return SimpleNamespace(device_type=kind,
                               time_range=SimpleNamespace(start=lo, end=hi))

    events = [event(DeviceType.CUDA, lo, hi)
              for lo, hi in ((20, 30), (0, 10), (5, 12), (21, 22))]
    events.append(event(DeviceType.CPU, 0, 100))
    assert device_busy_seconds(events) == pytest.approx(22e-6)
    assert device_busy_seconds([]) == 0.0


@pytest.mark.parametrize("script,argv", [
    ("halo_pipeline_run_torch.py", ["2", "50", "10", "8"]),
    ("halo_scale_run_torch.py", ["10", "8"]),
    ("lj_step_probe_torch.py", ["10", "8"]),
    ("dist_halo_record_torch.py", ["10"]),
    ("quality_roster_torch.py", ["--only", "planted:200"]),
    ("planted_precision_torch.py", ["--k", "4", "--m", "10"]),
])
def test_drivers_raise_without_a_card(monkeypatch, tmp_path, script, argv):
    """The new drivers default to the card and raise where there is none,
    before any work; they never fall back to the CPU."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = load(f"scripts/{script}", script[:-3] + "_nocard")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if script in ("quality_roster_torch.py",
                      "planted_precision_torch.py"):
            mod.main(argv)
        else:
            mod.main(["x"] + argv)
    assert os.listdir(tmp_path) == []
