"""The halo pipeline end to end at LiveJournal scale: the PyTorch port's
``embed(mesh=..., sharding="halo")`` against ``sharding="replicated"``.

The counterpart of scripts/halo_pipeline_run.py, with its arguments, stages
and record keys.  It reads the prep cache of scripts/lj_scale_run_torch.py
(``prep 22 8``), keeps the finest ``levels`` levels (the reference's
startLevel knob, examples/embedder.cpp:189-200) so that the coarsest kept
level is large enough for the multi-shard base case, and orders that level
by the dropped coarse levels (``base_order``: no new partition).  Per arm,
on a one-shard mesh:

  base case  halo: the halo step on the ordered level (invariant
             sampling); replicated: the replicated step, whose dense gram
             block [n, n] passes ``DENSE_D2_MAX_BYTES`` at LiveJournal
             scale, so it runs the sampled estimator;
  refinement every finer level of at least ``mesh_min_n`` vertices,
             aggregate-sharded (``parallel.sharded_ml``).

  python scripts/halo_pipeline_run_torch.py [levels] [base_iters] [scale] \\
      [ef] [arms] [--device d] [--out path]

``arms``: both (default), halo or replicated.  ``--device`` defaults to
``cuda`` and raises without a card (``--device cpu`` runs the plain
PyTorch versions).  Standard output, one JSON object per line, per arm:
each span of the embed with the kernel launches made inside it (``phase:
"span"``; the base span names the repulsion it ran; on the card each span
also gives ``device_seconds``, the time the card was busy inside it, from
``torch.profiler``), each level's buckets,
each refined level's largest distance outside its parent ball beside the
slack, the peak device memory, the unrounded stress, then the arm's record
(``{"arm": ...}``); last the combined record, which is also appended to
``--out`` (default ``halo_pipeline_torch.jsonl``).  Checkpoints
(``ckpt_pipe_<arm>_<levels>``, a re-run resumes) and the spans
(``halo_pipeline_<tag>_<arm>.metrics.jsonl``) go under the cache
directory, ``.lj_cache/torch/<tag>``.  ``LJ_X_PRECISION=bf16`` runs both
params at ``x_precision="bf16"``.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from lj_scale_run_torch import (ROOT, BallCheck, cache_dir,  # noqa: E402
                                card_label, emit, emit_buckets,
                                emit_memory, load_cache, log,
                                reset_peak_memory, run_tag, span_logger,
                                split_args)

OUT = "halo_pipeline_torch.jsonl"


def run_arm(sharding, graphs, parts, base_iters, scale_ef, rec, device,
            base_order=None):
    import graph_embed_tpu_torch as gp
    from graph_embed_tpu_torch.embed.checkpoint import CheckpointStore
    from graph_embed_tpu_torch.harness.runtests import layout_stress
    from graph_embed_tpu_torch.ops import cuda
    from graph_embed_tpu_torch.parallel.mesh import make_mesh
    from graph_embed_tpu_torch.utils.params import (ForceAtlasParams,
                                                    MultilevelFAParams)

    mesh = make_mesh(1, device=device)
    mesh_min_n = min(65536, graphs[-1].n)
    xprec = os.environ.get("LJ_X_PRECISION", "f32")
    kw = {}
    if xprec != "f32":
        kw = dict(base_params=ForceAtlasParams(x_precision=xprec),
                  refine_params=MultilevelFAParams(x_precision=xprec))
    d = cache_dir(*scale_ef)
    store = CheckpointStore(os.path.join(
        d, f"ckpt_pipe_{sharding}_{len(graphs)}"
        + ("" if xprec == "f32" else f"_{xprec}")))
    arm = {"sharding": sharding, "levels": len(graphs),
           "base_n": graphs[-1].n, "base_edges": graphs[-1].num_edges,
           "base_iterations": base_iters, "mesh_min_n": mesh_min_n}
    if xprec != "f32":
        arm["x_precision"] = xprec
    log(f"--- arm {sharding}: base level n={graphs[-1].n} "
        f"e={graphs[-1].num_edges}, {len(graphs)-1} refine levels")
    emit_buckets(parts, kw.get("refine_params", MultilevelFAParams()),
                 arm=sharding)
    balls = BallCheck()
    reset_peak_memory(device)
    # the spans count from this arm's zero
    cuda.LAUNCHES.clear()
    metrics = span_logger(os.path.join(
        d, f"halo_pipeline_{run_tag(*scale_ef)}_{sharding}.metrics.jsonl"),
        device_time=device.type == "cuda")
    t0 = time.perf_counter()
    coords = gp.embed(graphs, parts, 3, device=device, mesh=mesh,
                      sharding=sharding, mesh_min_n=mesh_min_n,
                      base_iterations=base_iters, metrics=metrics,
                      store=store, base_order=base_order, on_level=balls,
                      **kw)
    coords_np = coords.cpu().numpy()
    arm["embed_seconds"] = round(time.perf_counter() - t0, 1)
    metrics.close()
    for span in metrics.records:
        emit(phase="span", arm=sharding, span=span.pop("phase"), **span)
        if span.get("level") == len(graphs) - 1 and "repulsion" in span:
            arm["base_repulsion"] = span["repulsion"]
    balls.emit(arm=sharding)
    emit_memory(device, arm=sharding)
    arm["coords_finite"] = bool(np.isfinite(coords_np).all())
    t0 = time.perf_counter()
    stress = layout_stress(graphs[0], coords_np)
    arm["stress_seconds"] = round(time.perf_counter() - t0, 1)
    emit(phase="stress", arm=sharding, stress=stress)
    arm["stress"] = round(stress, 4)
    log(f"arm {sharding}: embed {arm['embed_seconds']}s "
        f"stress {arm['stress']} finite={arm['coords_finite']}")
    rec[sharding] = arm
    print(json.dumps({"arm": arm}), flush=True)


def main(argv):
    sys.path.insert(0, ROOT)
    from graph_embed_tpu_torch.graph.reorder import partition_order
    from graph_embed_tpu_torch.utils.device import resolve

    args, opts = split_args(argv, device="cuda", out=OUT)
    levels = int(args[0]) if len(args) > 0 else 2
    base_iters = int(args[1]) if len(args) > 1 else 1000
    scale = args[2] if len(args) > 2 else "22"
    scale = "mesh" if scale == "mesh" else int(scale)
    ef = int(args[3]) if len(args) > 3 else 8
    arms = args[4] if len(args) > 4 else "both"
    if arms not in ("both", "halo", "replicated"):
        raise SystemExit(f"unknown arms {arms!r}: both, halo or replicated")
    device, out = resolve(opts["device"]), opts["out"]

    graphs, parts, _ = load_cache(scale, ef)
    if levels < 2 or levels > len(graphs):
        raise SystemExit(f"levels must be in [2, {len(graphs)}]")
    # the truncated-away coarse levels carry the base level's locality
    # ordering for free (embed's base_order): no re-partition
    dropped = parts[levels - 1:]
    graphs = graphs[:levels]
    parts = parts[: levels - 1]
    base_order = None
    if dropped:
        t0 = time.perf_counter()
        base_order = partition_order(graphs[-1], levels=dropped)
        log(f"base_order from dropped levels "
            f"({time.perf_counter() - t0:.1f}s)")
    tag = run_tag(scale, ef)
    rec = {"workload": f"{tag} pipeline", "levels_kept": levels,
           "level_sizes": [g.n for g in graphs],
           "level_edges": [g.num_edges for g in graphs],
           "device": card_label(device)}
    for sharding in (("halo", "replicated") if arms == "both" else (arms,)):
        run_arm(sharding, graphs, parts, base_iters, (scale, ef), rec,
                device, base_order=base_order if sharding == "halo" else None)
    if "halo" in rec and "replicated" in rec:
        h, r = rec["halo"], rec["replicated"]
        rec["halo_vs_replicated_embed"] = round(
            h["embed_seconds"] / max(r["embed_seconds"], 1e-9), 2)
    print(json.dumps(rec), flush=True)
    with open(out, "a") as f:
        f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
