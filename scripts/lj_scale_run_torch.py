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


def synchronize(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


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


def span_logger(path):
    """The embed's MetricsLogger: each record also carries the kernel
    launches made since the previous one, and goes to a JSONL file."""
    from graph_embed_tpu_torch.ops import cuda
    from graph_embed_tpu_torch.utils.timing import MetricsLogger

    class SpanLogger(MetricsLogger):
        def __init__(self):
            super().__init__()
            self._seen = dict(cuda.LAUNCHES)
            self._fh = open(path, "a")

        def log(self, **record):
            now = dict(cuda.LAUNCHES)
            record["launches"] = {k: v - self._seen.get(k, 0)
                                  for k, v in now.items()
                                  if v != self._seen.get(k, 0)}
            self._seen = now
            self._fh.write(json.dumps(dict(record, t=time.time())) + "\n")
            self._fh.flush()
            return super().log(**record)

        def close(self):
            self._fh.close()

    return SpanLogger()


def run_embed(scale, ef, rec, device):
    import torch

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
    for l, part in enumerate(parts):
        classes = buckets_of(part, refine_params)
        emit(phase="buckets", level=l,
             sampled=[[S, m_b] for S, m_b, smp in classes if smp],
             exact=[[S, m_b] for S, m_b, smp in classes if not smp],
             slots=sum(S * m_b for S, m_b, _ in classes))

    balls = {}

    def check_level(level, coords, part, centres, radii):
        """How far the level's farthest vertex lies outside its parent
        ball, beside the float32 slack of a centre's magnitude."""
        v2a = part.vertex_to_agg
        dist = torch.linalg.norm(coords - centres[v2a], dim=1)
        balls[level] = dict(
            excess=float((dist - radii[v2a]).max()),
            slack=1e-5 * float(centres.abs().max()) + 1e-6,
            finite=bool(torch.isfinite(coords).all()))

    ck = "ckpt" if xprec == "f32" else f"ckpt_{xprec}"
    d = cache_dir(scale, ef)
    store = CheckpointStore(os.path.join(d, ck))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    cuda.LAUNCHES.clear()
    metrics = span_logger(os.path.join(d, "metrics.jsonl"))
    t0 = time.perf_counter()
    coords = gp.embed(graphs, parts, 3, device=device, metrics=metrics,
                      store=store, on_level=check_level,
                      base_params=base_params, refine_params=refine_params)
    coords_np = coords.cpu().numpy()
    rec["embed_seconds"] = round(time.perf_counter() - t0, 1)
    metrics.close()
    for span in metrics.records:
        emit(phase="span", span=span.pop("phase"), **span)
    emit(phase="balls", levels={str(k): v for k, v in sorted(balls.items())})
    emit(phase="memory", device=str(device),
         max_memory_allocated=(torch.cuda.max_memory_allocated(device)
                               if device.type == "cuda" else None),
         launches=dict(cuda.LAUNCHES))

    assert np.isfinite(coords_np).all(), "non-finite coords"
    rec["coords_finite"] = True
    t0 = time.perf_counter()
    stress = layout_stress(g, coords_np)
    emit(phase="stress", stress=stress)
    rec["stress"] = round(stress, 4)
    rec["stress_seconds"] = round(time.perf_counter() - t0, 1)
    print(json.dumps(rec), flush=True)
    return coords_np


def parse_args(argv):
    """(stage, scale, ef, device) from ``[stage] [scale] [ef]`` and an
    optional ``--device d`` anywhere."""
    args, device = [], "cuda"
    it = iter(argv[1:])
    for a in it:
        if a == "--device":
            device = next(it)
        else:
            args.append(a)
    stage = args[0] if args else "all"
    raw = args[1] if len(args) > 1 else "22"
    scale = "mesh" if raw == "mesh" else int(raw)
    ef = int(args[2]) if len(args) > 2 else 8
    return stage, scale, ef, device


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
