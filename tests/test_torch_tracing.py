"""The port's tracer (``utils/timing.py``): the sub-spans and counters
inside an embed's phases, their stamps on the profiler's clock, their
cost where no logger is current, the benchmark's ``SpanLogger`` reading
them, and on the card (marker ``cuda``) the card's work placed by the
stamps alone.  The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_tracing.py
"""

import collections
import dataclasses
import itertools
import json
import tracemalloc

import pytest
import torch

import graph_embed_tpu_torch as gp
from graph_embed_tpu_torch.forceatlas import multilevel_tiled as MT
from graph_embed_tpu_torch.ops import cuda
from graph_embed_tpu_torch.utils import profiling, timing
from graph_embed_tpu_torch.utils.params import MultilevelFAParams

BASE_ITERS = 30
COUNTER = "graph_to_host_bytes"


@pytest.fixture(scope="module")
def embedded():
    """A CPU embed of mesh3d(10) with its records."""
    metrics = gp.MetricsLogger()
    coords, res = gp.embed_graph(gp.synth.mesh3d(10), 3, device="cpu",
                                 base_iterations=BASE_ITERS,
                                 refine_iterations=3, metrics=metrics)
    return coords, res, metrics.records


def subs(records, name):
    return [sub for rec in records for sub in rec.get("sub", ())
            if sub["name"] == name]


def counted(records) -> collections.Counter:
    """Every count of the records and their sub-spans, summed."""
    out = collections.Counter()
    for rec in records:
        out.update(rec.get("counts", {}))
        for sub in rec.get("sub", ()):
            out.update(sub.get("counts", {}))
    return out


def test_embed_records_base_loop_and_layout_sub_spans(embedded):
    _, res, records = embedded
    base = [r for r in records if r["phase"] == "base"]
    assert len(base) == 1
    assert [(s["name"], s["iterations"]) for s in base[0]["sub"]] == [
        ("base.loop", BASE_ITERS)]
    layouts = [r for r in records if r["phase"] == "layout"]
    refines = [r for r in records if r["phase"] == "refine"]
    assert len(layouts) == len(res.levels)
    assert {r["route"] for r in refines} == {"tiled"}
    for rec in layouts:
        assert [s["name"] for s in rec["sub"]] == ["layout.slots",
                                                   "layout.csr"]
    # no sub-span lands outside its phase's record
    assert len(subs(records, "base.loop")) == 1
    assert len(subs(records, "layout.csr")) == len(res.levels)


def test_sub_spans_lie_inside_their_phase(embedded):
    _, _, records = embedded
    for prev, rec in zip(records, records[1:]):
        assert prev["t1_ns"] <= rec["t0_ns"]
    for rec in records:
        assert rec["t0_ns"] <= rec["t1_ns"]
        assert rec["t1_ns"] - rec["t0_ns"] >= 0.99e9 * rec["seconds"]
        for i, sub in enumerate(rec.get("sub", ())):
            assert rec["t0_ns"] <= sub["t0_ns"] <= sub["t1_ns"] \
                <= rec["t1_ns"]
            assert 0.0 <= sub["seconds"] <= rec["seconds"]
            if sub["parent"] is not None:
                up = rec["sub"][sub["parent"]]
                assert sub["parent"] < i
                assert up["t0_ns"] <= sub["t0_ns"] <= sub["t1_ns"] \
                    <= up["t1_ns"]


def test_count_attributes_each_unit_once():
    """A unit counted goes to the innermost open sub-span, else to the
    phase; nested sub-spans name their parent; without a current logger
    nothing is counted."""
    metrics = gp.MetricsLogger()
    timing.count(COUNTER, 1000)
    with timing.use(metrics):
        with metrics.span("phase"):
            timing.count(COUNTER, 1)
            with timing.span("outer", k=7):
                timing.count(COUNTER, 10)
                with timing.span("inner"):
                    timing.count(COUNTER, 100)
                    timing.count("other", 5)
                timing.count(COUNTER, 10)
            with timing.span("second"):
                pass
            timing.count(COUNTER, 1)
    timing.count(COUNTER, 1000)
    (rec,) = metrics.records
    assert rec["counts"] == {COUNTER: 2}
    outer, inner, second = rec["sub"]
    assert (outer["name"], outer["k"], outer["parent"]) == ("outer", 7, None)
    assert outer["counts"] == {COUNTER: 20}
    assert inner["parent"] == 0
    assert inner["counts"] == {COUNTER: 100, "other": 5}
    assert second["parent"] is None and "counts" not in second
    assert counted(metrics.records) == {COUNTER: 122, "other": 5}


def test_launches_since_the_previous_record(monkeypatch):
    """A record carries the kernel launches made since the previous one
    (or since its logger became current), and none where there were
    none."""
    monkeypatch.setattr(cuda, "LAUNCHES", collections.Counter(
        {"edge_spmm[unit]": 4}))
    metrics = gp.MetricsLogger()
    with timing.use(metrics):
        with metrics.span("a"):
            cuda.LAUNCHES["edge_spmm[unit]"] += 2
            cuda.LAUNCHES["fused_step"] += 1
        with metrics.span("b"):
            pass
        cuda.LAUNCHES["fused_step"] += 3
        metrics.log(phase="c")
    a, b, c = metrics.records
    assert a["launches"] == {"edge_spmm[unit]": 2, "fused_step": 1}
    assert "launches" not in b and c == {"phase": "c",
                                         "launches": {"fused_step": 3}}


def test_tracing_leaves_the_results_unchanged():
    """The flat layout and the slot layout are the same, bit for bit,
    with no logger current and inside a phase of one, and a span with
    no logger current is the shared null context and allocates
    nothing."""
    g = gp.synth.mesh3d(8)
    part = gp.partition_hierarchy(g, 0.25).levels[0]

    def run():
        coords = gp.force_atlas(g, 3, iterations=5, seed=3, device="cpu")
        lay = MT.prepare_refine(g, part, MultilevelFAParams())
        return coords, lay.slot_of_vertex, lay.csr.col, lay.deg_loc

    bare = run()
    metrics = gp.MetricsLogger()
    with timing.use(metrics), metrics.span("phase"):
        traced = run()
    assert [s["name"] for s in metrics.records[0]["sub"]] == [
        "base.loop", "layout.slots", "layout.csr"]
    for a, b in zip(bare, traced):
        assert torch.equal(a, b)

    assert timing.span("a") is timing.span("b", n=1)

    def loop(n):
        for _ in itertools.repeat(None, n):
            with timing.span("x"):
                pass
            timing.count(COUNTER, 1)

    tracemalloc.start()
    try:
        loop(100)
        before = tracemalloc.get_traced_memory()
        loop(10_000)
        after = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert after == before


def test_resume_record_is_unchanged(tmp_path):
    """A store's resume record stays {"phase", "level"} while the phases
    after it carry their sub-spans."""
    from graph_embed_tpu_torch.embed.checkpoint import CheckpointStore

    g = gp.synth.mesh3d(8)
    res = gp.partition_hierarchy(g, 0.25, emit_graphs=True)
    graphs, k = [g] + res.coarse_graphs, len(res.levels)
    kw = dict(device="cpu", base_iterations=20, refine_iterations=2, seed=4)
    store = CheckpointStore(str(tmp_path))
    fresh = gp.embed(graphs, res.levels, 3, store=store, **kw)
    store = CheckpointStore(str(tmp_path / "resumed"))
    store.save_level(k, **CheckpointStore(str(tmp_path)).load_level(k))
    metrics = gp.MetricsLogger()
    resumed = gp.embed(graphs, res.levels, 3, store=store, metrics=metrics,
                       **kw)
    assert metrics.records[0] == {"phase": "resume", "level": k}
    assert len(subs(metrics.records, "layout.slots")) == k
    assert torch.equal(resumed, fresh)


def test_profiler_regions_on_the_stamps_clock(tmp_path):
    """Under a profiler each phase and sub-span is a named region whose
    start the profiler reports inside the span's own stamps: the two share
    a clock."""
    metrics = gp.MetricsLogger()
    with profiling.trace(str(tmp_path)) as prof:
        gp.embed_graph(gp.synth.mesh3d(8), 3, device="cpu",
                       base_iterations=5, refine_iterations=2,
                       metrics=metrics)
    spans = {}
    for rec in metrics.records:
        spans.setdefault(rec["phase"], []).append(rec)
        for sub in rec.get("sub", ()):
            spans.setdefault(sub["name"], []).append(sub)
    starts = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name() in spans:
            starts[e.name()].append((e.start_ns(),
                                     e.start_ns() + e.duration_ns()))
    assert {"base", "base.loop", "layout.slots", "layout.csr"} <= set(starts)
    for name, got in starts.items():
        want = spans[name]
        assert len(got) == len(want), name
        for (start, end), sp in zip(sorted(got), want):
            assert sp["t0_ns"] <= start <= end <= sp["t1_ns"], name
    names = {e.get("name") for e in json.loads(
        (tmp_path / "trace.json").read_text())["traceEvents"]}
    assert {"base", "base.loop", "layout.csr"} <= names


@pytest.mark.parametrize("traced", [False, True])
def test_benchmark_span_logger_reads_the_sub_spans(monkeypatch, traced):
    """The benchmark's ``SpanLogger`` (the window's plain spans, and the
    traced embed's spans each under its own profiler: here the CPU's)
    keeps the sub-spans on its records, which the driver's trace totals
    and every embed reader accept."""
    from portbench import harness, program
    from portbench import trace as TR
    from portbench.conftest import ROOT as root

    monkeypatch.setattr(TR, "profile", lambda device: torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU]))
    names = [m["name"] for m in harness.resolve(
        root, "mesh3d-128.embed").per_layer]
    driver = harness.load_module(root, "drivers", "embed")
    g = program.program_graph(harness.load_module(
        root, "generators", "mesh3d").build({"side": 8}, 1, "cpu"))
    e = driver.one_embed(gp.embed_graph, g, 3, torch.device("cpu"),
                         dict(coarsening_factor=0.1, refine_iterations=2,
                              base_iterations=20), 5, traced)
    assert len(subs(e["spans"], "base.loop")) == 1
    assert len(subs(e["spans"], "layout.slots")) >= 1
    if traced:
        busy, window, _, kernels = driver._trace_totals(e)
        assert busy == 0.0 and kernels == {}
        assert window == pytest.approx(sum(sp["seconds"]
                                           for sp in e["spans"]))
    rec = {"embeds": [{"seconds": e["seconds"], "traced": False,
                       "spans": [{k: v for k, v in sp.items()
                                  if k != "kernels"} for sp in e["spans"]]}]}
    read = {m: harness.load_module(root, "metrics", m).read(rec)
            for m in names}
    assert read["embed.base_iter_us"] == pytest.approx(
        1e6 * subs(e["spans"], "base.loop")[0]["seconds"] / 20)
    assert 0 < read["embed.layout_slots_s"] + read["embed.layout_csr_s"] \
        <= read["embed.layout_s"]
    # on the CPU nothing goes to the host, and no card time is read
    for m in ("embed.graph_to_host_mb", "embed.base_card_iter_us",
              "embed.base_busy_pct", "device_idle_pct.embed"):
        assert read[m] is None, m


# -- on the card ---------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def card_mesh(dev):
    """mesh3d(16) on the card, after one embed that builds the kernels."""
    g = gp.synth.mesh3d(16).to(dev)
    gp.embed_graph(g, 3, device=dev, base_iterations=5, refine_iterations=2)
    torch.cuda.synchronize()
    return g


@pytest.mark.cuda
def test_card_base_loop_holds_its_kernel_a_launches(dev, card_mesh):
    """Under a CUDA-only profiler, the device intervals assigned to spans
    by their stamps alone: exactly one kernel-A interval per base-case
    iteration starts inside ``base.loop`` (its end widened by 1 ms)."""
    metrics = gp.MetricsLogger()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        gp.embed_graph(card_mesh, 3, device=dev, base_iterations=50,
                       refine_iterations=5, metrics=metrics)
        torch.cuda.synchronize()
    starts = [e.start_ns() for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA
              and "spmv_kernel" in e.name()]
    (loop,) = subs(metrics.records, "base.loop")
    assert loop["iterations"] == 50
    inside = [t for t in starts if loop["t0_ns"] <= t <= loop["t1_ns"]
              + 1_000_000]
    assert len(inside) == 50 and len(starts) > 50
    base = [r for r in metrics.records if r["phase"] == "base"][0]
    assert base["launches"]["edge_spmm[weighted]"] == 50


@pytest.mark.cuda
def test_card_graph_to_host_bytes_hand_count(dev, card_mesh):
    """A card-only graph's copies to the host, counted: level 0's COO
    (int64 senders and receivers, float32 weights) in the Galerkin chain
    and in level 0's slot layout; each level's aggregate map (int64) in
    the chain and in its layout prep, and the maps of levels 1 to k-1
    again as the radii's grandparents."""
    g = dataclasses.replace(card_mesh, host_coo=None)
    metrics = gp.MetricsLogger()
    _, res = gp.embed_graph(g, 3, device=dev, base_iterations=50,
                            refine_iterations=5, metrics=metrics)
    n = res.level_sizes
    k = len(res.levels)
    want = (2 * 20 * g.num_edges + 8 * 2 * sum(n[:k])
            + 8 * sum(n[1:k]))
    assert counted(metrics.records)[COUNTER] == want
    assert [r["phase"] for r in metrics.records][:2] == ["partition",
                                                        "galerkin"]


@pytest.mark.cuda
def test_card_chrome_trace_holds_the_spans(dev, card_mesh, tmp_path):
    with profiling.trace(str(tmp_path)):
        gp.embed_graph(card_mesh, 3, device=dev, base_iterations=50,
                       refine_iterations=5)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"base", "base.loop", "layout.csr"} <= names
    assert any("spmv_kernel" in (e.get("name") or "") for e in events)
