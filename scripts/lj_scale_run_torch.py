"""LiveJournal-scale end-to-end run of the PyTorch port (BASELINE config 4).

The counterpart of scripts/lj_scale_run.py, with its stages, arguments and
record keys.  com-lj is 4M vertices / 34.7M edges (~69M stored symmetric
entries, run-tests.cpp:399); its stand-in is rmat(22, 8, seed=1) rebuilt
with unit weights (com-lj is unweighted; the generator's weights count
duplicate draws).  Pipeline = examples/embedder.cpp:140-295: native
partition with the emitted Galerkin chain -> multilevel embed (slot-space
refinement, sampled buckets for size classes of at least 2048 slots, the
native radii sweep for hub grandparents) -> finite check + layout stress.

  python scripts/lj_scale_run_torch.py [stage] [scale] [ef] [--device d]
  python scripts/lj_scale_run_torch.py [stage] mesh <L> [--device d]

``mesh 256`` is the delaunay_n24 stand-in, mesh3d(256).  ``--device``
defaults to ``cuda``; without a card the script raises (pass ``--device
cpu`` for the plain PyTorch versions on the CPU).

stages:
  prep     generate the graph, partition it (native coarsener, which emits
           the Galerkin chain) and cache graph{l}.npz (s, r, w, n),
           parts.npz (v2a{l}) and prep.json, the JAX script's format,
           under .lj_cache/torch/<tag>
  refine0  the finest level's refinement alone: prepare_refine's seconds
           and buckets, then refine_level_tiled at 2, 2, 10 and 10
           iterations against a seeded random parent layout
  embed    the multilevel embed from the cache, checkpointed under the
           cache (a re-run resumes after the last completed level)
  all      prep (if not cached) + embed            [default]

The embed prints, one JSON object per line on standard output: each span
of the embed with the kernel launches made inside it (``phase: "span"``),
each level's buckets (``phase: "buckets"``: size class S, aggregates m_b,
exact or sampled), each refined level's largest distance outside its parent
ball beside the slack allowed (``phase: "balls"``), the peak device memory
(``phase: "memory"``), and last the JAX script's record.  The spans also go
to ``metrics.jsonl`` in the cache directory.  ``LJ_X_PRECISION=bf16`` runs
the embed with ``x_precision="bf16"`` in both params.

The base case takes the library default of iterations
(``default_base_iterations``: min(100k, max(10k, 12 n))).
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE_ROOT = os.path.join(ROOT, ".lj_cache", "torch")


def log(msg):
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def emit(**record):
    print(json.dumps(record), flush=True)


def run_tag(scale, ef):
    return f"mesh3d_{ef}" if scale == "mesh" else f"rmat{scale}_{ef}"


def cache_dir(scale, ef):
    d = os.path.join(CACHE_ROOT, run_tag(scale, ef))
    os.makedirs(d, exist_ok=True)
    return d


def card_label(device) -> str:
    """What a record says of where it ran: "cpu", or the card's name and
    power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` prints them for ``device``'s index (a card
    may be capped below its maximum power and then runs slower, so a time
    is kept beside the limit it was taken under)."""
    import subprocess

    import torch

    if device.type == "cpu":
        return "cpu"
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()


def synchronize(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def middle_seconds(run, iters, device, runs=3):
    """Seconds per iteration of ``run(iters)``: the middle of ``runs``
    timings, by CUDA events on a card (no host sync inside a run), by the
    host clock after a synchronize on the CPU."""
    import torch

    times = []
    for _ in range(runs):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run(iters)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3 / iters)
        else:
            t0 = time.perf_counter()
            run(iters)
            times.append((time.perf_counter() - t0) / iters)
    return sorted(times)[len(times) // 2]


def plan_facts(csr, prefix=""):
    """What a CSR plan holds: its entries, its hub rows (more than
    ``cuda.SPMV_HUB_ROW`` entries) and whether it carries weights (kernel
    A weighted, else unit)."""
    return {f"{prefix}entries": 0 if csr is None else csr.nnz,
            f"{prefix}hub_rows": (0 if csr is None
                                  else int(csr.hub_rows.numel())),
            f"{prefix}weighted": csr is not None and csr.w is not None}


def prep(scale, ef, rec):
    """Generate + partition (the native coarsener emits the Galerkin
    chain); cache each level's COO and v2a."""
    import graph_embed_tpu_torch as gp
    from graph_embed_tpu_torch.graph import synth

    d = cache_dir(scale, ef)
    done = os.path.join(d, "prep.json")
    if os.path.exists(done):
        with open(done) as f:
            rec.update(json.load(f))
        log(f"prep: cached ({rec['level_sizes']})")
        return
    t0 = time.perf_counter()
    if scale == "mesh":
        g = synth.cached("mesh3d", ef)
    else:
        # simple-graph weights (com-lj is unweighted): the cached COO is
        # canonical, so the unit rebuild is one from_canonical_coo
        s, r, _, n = synth.cached_arrays("rmat", scale, ef, seed=1,
                                         load_weights=False)
        g = gp.from_canonical_coo(s, r, np.ones(s.size, np.float32), n)
    rec["gen_seconds"] = round(time.perf_counter() - t0, 1)
    rec["n"], rec["edges"] = g.n, g.num_edges
    log(f"graph: n={g.n} stored={g.num_edges} ({rec['gen_seconds']}s)")

    t0 = time.perf_counter()
    hier = gp.partition_hierarchy(g, 0.1, emit_graphs=True)
    rec["partition_seconds"] = round(time.perf_counter() - t0, 1)
    rec["level_sizes"] = hier.level_sizes
    rec["modularity"] = round(float(hier.modularity), 4)
    log(f"partition: {hier.level_sizes} Q={hier.modularity:.4f} "
        f"({rec['partition_seconds']}s)")

    t0 = time.perf_counter()
    graphs = ([g] + hier.coarse_graphs if hier.coarse_graphs is not None
              else gp.build_galerkin_chain(g, hier.levels))
    rec["galerkin_seconds"] = round(time.perf_counter() - t0, 1)
    rec["level_edges"] = [gg.num_edges for gg in graphs]
    log(f"galerkin: {rec['level_edges']} ({rec['galerkin_seconds']}s)")

    for l, gg in enumerate(graphs):
        ss, rr, ww = gg.to_coo_numpy()
        np.savez(os.path.join(d, f"graph{l}.npz"), s=ss, r=rr, w=ww, n=gg.n)
    np.savez(os.path.join(d, "parts.npz"),
             **{f"v2a{l}": p.vertex_to_agg_numpy()
                for l, p in enumerate(hier.levels)})
    with open(done, "w") as f:
        json.dump(rec, f)
    log("prep: cached to disk")


def load_cache(scale, ef):
    """(graphs, parts, prep record) from the cache, on the host.  The
    cached COOs are canonical (sorted, deduplicated), as both scripts'
    ``to_coo_numpy`` give them."""
    import graph_embed_tpu_torch as gp

    d = cache_dir(scale, ef)
    with open(os.path.join(d, "prep.json")) as f:
        rec = json.load(f)
    graphs = []
    for l in range(len(rec["level_sizes"])):
        z = np.load(os.path.join(d, f"graph{l}.npz"))
        t0 = time.perf_counter()
        graphs.append(gp.from_canonical_coo(z["s"], z["r"], z["w"],
                                            int(z["n"])))
        log(f"load graph{l}: n={int(z['n'])} e={z['s'].size} "
            f"({time.perf_counter() - t0:.1f}s)")
    pz = np.load(os.path.join(d, "parts.npz"))
    parts = [gp.Partition.from_numpy(pz[f"v2a{l}"], graphs[l + 1].n)
             for l in range(len(graphs) - 1)]
    return graphs, parts, rec


def buckets_of(part, params):
    """Each size class of a level's refinement, as ``prepare_refine``
    lays it out: (S, aggregates, sampled)."""
    from graph_embed_tpu_torch.forceatlas.multilevel_tiled import (
        size_classes)

    counts = np.bincount(part.vertex_to_agg_numpy(), minlength=part.num_aggs)
    thr = params.sampled_slots_threshold
    return [(S, int(aggs.size), thr > 0 and S >= thr)
            for S, aggs in size_classes(counts)]


def emit_buckets(parts, params, **fields):
    """One ``phase: "buckets"`` line per level to refine: its size
    classes, sampled and exact, and its slots."""
    for l, part in enumerate(parts):
        classes = buckets_of(part, params)
        emit(phase="buckets", level=l,
             sampled=[[S, m_b] for S, m_b, smp in classes if smp],
             exact=[[S, m_b] for S, m_b, smp in classes if not smp],
             slots=sum(S * m_b for S, m_b, _ in classes), **fields)


class BallCheck:
    """The embed's ``on_level``: how far each refined level's farthest
    vertex lies outside its parent ball, beside the float32 slack of a
    centre's magnitude."""

    def __init__(self):
        self.levels = {}

    def __call__(self, level, coords, part, centres, radii):
        import torch

        v2a = part.vertex_to_agg
        dist = torch.linalg.norm(coords - centres[v2a], dim=1)
        self.levels[level] = dict(
            excess=float((dist - radii[v2a]).max()),
            slack=1e-5 * float(centres.abs().max()) + 1e-6,
            finite=bool(torch.isfinite(coords).all()))

    def emit(self, **fields):
        emit(phase="balls", levels={str(k): v for k, v
                                    in sorted(self.levels.items())},
             **fields)


def reset_peak_memory(device):
    """Start the peak device memory count afresh (CUDA's state
    initialised first: a device with an explicit index does not do it)."""
    import torch

    if device.type == "cuda":
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)


def emit_memory(device, **fields):
    """The peak device memory since the last reset, and the launches."""
    import torch

    from graph_embed_tpu_torch.ops import cuda

    emit(phase="memory", device=str(device),
         max_memory_allocated=(torch.cuda.max_memory_allocated(device)
                               if device.type == "cuda" else None),
         launches=dict(cuda.LAUNCHES), **fields)


def probe_refine0(scale, ef, device):
    """Sub-phase timing of the finest level's refinement."""
    import torch

    from graph_embed_tpu_torch.forceatlas.multilevel_tiled import (
        prepare_refine, refine_level_tiled)
    from graph_embed_tpu_torch.utils.params import MultilevelFAParams

    graphs, parts, rec = load_cache(scale, ef)
    g, part = graphs[0].to(device), parts[0].to(device)
    m = part.num_aggs
    params = MultilevelFAParams()
    log(f"refine0 probe: n={g.n} e={g.num_edges} aggs={m}")

    t0 = time.perf_counter()
    layout = prepare_refine(g, part, params)
    synchronize(device)
    log(f"prepare_refine: {time.perf_counter() - t0:.1f}s  "
        f"n_slots={layout.n_slots}")
    for b in layout.buckets:
        log(f"  bucket S={b.S:<7} m_b={b.m_b:<7} "
            f"kind={'sampled' if b.sampled else 'exact'} "
            f"slots={b.m_b * b.S}")

    # a random parent layout: the shapes of the real pipeline
    gen = torch.Generator(device=device).manual_seed(0)
    coords_A = torch.rand((m, 3), generator=gen, device=device) * 2.0 - 1.0
    r_A = torch.full((m,), 0.05, device=device)
    for iters in (2, 2, 10, 10):
        t0 = time.perf_counter()
        out = refine_level_tiled(g, part, coords_A, r_A, 3, iterations=iters,
                                 params=params, layout=layout)
        chk = float(out.sum())
        log(f"refine iters={iters}: {time.perf_counter() - t0:.1f}s "
            f"(chk={chk:.3e})")


def device_busy_seconds(events) -> float:
    """Seconds in which the card ran something (kernel, copy, memset):
    the union of the device intervals among a profiler's ``events()``."""
    from torch.autograd import DeviceType

    busy, end = 0.0, float("-inf")
    for lo, hi in sorted((e.time_range.start, e.time_range.end)
                         for e in events
                         if e.device_type == DeviceType.CUDA):
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy / 1e6


def span_logger(path, device_time=False):
    """The embed's MetricsLogger: each record also goes to a JSONL file,
    with the kernel launches made inside it (the logger's ``launches``; {}
    where it launched none).  With ``device_time`` each span runs under
    ``torch.profiler`` (CUDA activity only) and its record gains
    ``device_seconds``, the time in which the card was busy inside it
    (``device_busy_seconds``)."""
    import contextlib

    import torch

    from graph_embed_tpu_torch.utils.timing import MetricsLogger

    class SpanLogger(MetricsLogger):
        def __init__(self):
            super().__init__()
            self._fh = open(path, "a")

        def log(self, **record):
            record = super().log(**record)
            record.setdefault("launches", {})
            self._fh.write(json.dumps(dict(record, t=time.time())) + "\n")
            self._fh.flush()
            return record

        @contextlib.contextmanager
        def span(self, phase, device=None, **fields):
            if not device_time:
                with super().span(phase, device, **fields):
                    yield
                return
            activity = torch.profiler.ProfilerActivity.CUDA
            t0 = time.perf_counter()
            with torch.profiler.profile(activities=[activity]) as prof:
                yield
                synchronize(device)
                seconds = time.perf_counter() - t0
            self.log(phase=phase, seconds=seconds,
                     device_seconds=device_busy_seconds(prof.events()),
                     **fields)

        def close(self):
            self._fh.close()

    return SpanLogger()


def run_embed(scale, ef, rec, device):
    import graph_embed_tpu_torch as gp
    from graph_embed_tpu_torch.embed.checkpoint import CheckpointStore
    from graph_embed_tpu_torch.harness.runtests import layout_stress
    from graph_embed_tpu_torch.ops import cuda
    from graph_embed_tpu_torch.utils.params import (ForceAtlasParams,
                                                    MultilevelFAParams)

    graphs, parts, prep_rec = load_cache(scale, ef)
    rec.update(prep_rec)
    g = graphs[0]
    # LJ_X_PRECISION=bf16 runs the whole pipeline on the bf16 gather
    # layout (ForceAtlasParams.x_precision; base and refinement attraction)
    xprec = os.environ.get("LJ_X_PRECISION", "f32")
    base_params = ForceAtlasParams(x_precision=xprec)
    refine_params = MultilevelFAParams(x_precision=xprec)
    rec["base_iterations"] = gp.default_base_iterations(graphs[-1].n,
                                                        base_params)
    if xprec != "f32":
        rec["x_precision"] = xprec
    emit_buckets(parts, refine_params)
    balls = BallCheck()
    ck = "ckpt" if xprec == "f32" else f"ckpt_{xprec}"
    d = cache_dir(scale, ef)
    store = CheckpointStore(os.path.join(d, ck))
    reset_peak_memory(device)
    cuda.LAUNCHES.clear()
    metrics = span_logger(os.path.join(d, "metrics.jsonl"))
    t0 = time.perf_counter()
    coords = gp.embed(graphs, parts, 3, device=device, metrics=metrics,
                      store=store, on_level=balls,
                      base_params=base_params, refine_params=refine_params)
    coords_np = coords.cpu().numpy()
    rec["embed_seconds"] = round(time.perf_counter() - t0, 1)
    metrics.close()
    for span in metrics.records:
        emit(phase="span", span=span.pop("phase"), **span)
    balls.emit()
    emit_memory(device)

    assert np.isfinite(coords_np).all(), "non-finite coords"
    rec["coords_finite"] = True
    t0 = time.perf_counter()
    stress = layout_stress(g, coords_np)
    emit(phase="stress", stress=stress)
    rec["stress"] = round(stress, 4)
    rec["stress_seconds"] = round(time.perf_counter() - t0, 1)
    print(json.dumps(rec), flush=True)
    return coords_np


def split_args(argv, **defaults):
    """(positional arguments, options) of ``argv[1:]``: each ``--name
    value`` whose name is a key of ``defaults`` anywhere, the rest in
    order; options not given keep their defaults."""
    args, opts = [], dict(defaults)
    it = iter(argv[1:])
    for a in it:
        if a.startswith("--") and a[2:] in opts:
            opts[a[2:]] = next(it)
        else:
            args.append(a)
    return args, opts


def parse_args(argv):
    """(stage, scale, ef, device) from ``[stage] [scale] [ef]`` and an
    optional ``--device d`` anywhere."""
    args, opts = split_args(argv, device="cuda")
    stage = args[0] if args else "all"
    raw = args[1] if len(args) > 1 else "22"
    scale = "mesh" if raw == "mesh" else int(raw)
    ef = int(args[2]) if len(args) > 2 else 8
    return stage, scale, ef, opts["device"]


def main(argv):
    sys.path.insert(0, ROOT)
    from graph_embed_tpu_torch.utils.device import resolve

    stage, scale, ef, device = parse_args(argv)
    if stage not in ("prep", "refine0", "embed", "all"):
        raise SystemExit(f"unknown stage {stage!r}: prep, refine0, embed "
                         "or all")
    device = resolve(device)
    name = f"mesh3d({ef})" if scale == "mesh" else f"rmat({scale},{ef})"
    rec = {"workload": name}
    if stage in ("prep", "all"):
        prep(scale, ef, rec)
    if stage == "refine0":
        probe_refine0(scale, ef, device)
    if stage in ("embed", "all"):
        run_embed(scale, ef, rec, device)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
