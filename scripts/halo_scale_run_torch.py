"""The halo-sharded flat step at LiveJournal scale on the card, against the
flat tiled step on the same ordered graph (the PyTorch port).

The counterpart of scripts/halo_scale_run.py, with its arguments, stages
and record keys.  It reads the prep cache of scripts/lj_scale_run_torch.py
(``prep 22 8``) and orders the fine graph by the cached hierarchy (no new
partition), then:

  1. host: ``build_halo_plan`` at 8 shards, the plan that would shard the
     graph over 8 cards: its boundary fraction and the floats a step
     exchanges, against the replicated design's 2 * 8 * blk * 3;
  2. card, one shard: the halo step (``make_halo_fa_step`` with invariant
     sampling) on ``build_halo_csr`` (kernel A): the first iteration's
     seconds, then ms per iteration and stored entries per second;
  3. the same for the flat tiled step (``prepare_tiled`` +
     ``fa_step_tiled``: kernels A and D) on the same ordered graph.

Each step is timed by CUDA events: the middle of 3 runs of 10 iterations,
after a first iteration timed apart (its seconds under the JAX record's
``*_compile_seconds`` keys; nothing is compiled here).  Dim 3, sampled
repulsion with 64 samples, ``x_precision`` from ``LJ_X_PRECISION``.

  python scripts/halo_scale_run_torch.py [scale] [ef] [B W] \\
      [--device d] [--out path]

``B W`` pass on to ``prepare_tiled(sender_block=B, window=W, tile=1024)``,
where they shape the arithmetic rules of the flat plan; the halo CSR has
no such rule.  ``HALO_SCALE_REP_ONLY=1`` skips the halo step (stage 2).
TPU layout keys (slabs, fill, chunks) have no meaning on one CSR; the
record holds each plan's entries, hub rows and DIA offsets instead, and
each step's kernel launches.  The record is printed and appended to
``--out`` (default ``halo_scale_torch.jsonl``).  ``--device`` defaults to
``cuda`` and raises without a card (``--device cpu``: plain versions).
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from lj_scale_run_torch import (ROOT, card_label, load_cache,  # noqa: E402
                                log, middle_seconds, plan_facts,
                                split_args, synchronize)

OUT = "halo_scale_torch.jsonl"
ITERS = 10


def launches_since(before):
    from graph_embed_tpu_torch.ops import cuda

    return {k: v - before.get(k, 0) for k, v in cuda.LAUNCHES.items()
            if v != before.get(k, 0)}


def run_halo(rec, g_ord, params, device):
    """Stage 2: the halo step at one shard; returns seconds per
    iteration."""
    import torch

    from graph_embed_tpu_torch.ops import cuda
    from graph_embed_tpu_torch.parallel.halo import (build_halo_csr,
                                                     build_halo_plan,
                                                     make_halo_fa_step)
    from graph_embed_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(1, device=device)
    t0 = time.perf_counter()
    plan1 = build_halo_plan(g_ord, 1)
    tiles = build_halo_csr(plan1, params, device=device)
    synchronize(device)
    rec["tiles_seconds"] = round(time.perf_counter() - t0, 1)
    rec.update(plan_facts(tiles.csr, "tiles_"))
    log(f"halo CSR: {rec['tiles_entries']} entries, "
        f"{rec['tiles_hub_rows']} hub rows ({rec['tiles_seconds']}s)")
    step = make_halo_fa_step(mesh, plan1, 3, params, sample_mode="invariant",
                             tiles=tiles)
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.rand((plan1.ndev * plan1.blk, 3), generator=gen,
                   device=device) * 2.0 - 1.0
    fprev = torch.zeros_like(x)
    state = [x, fprev]

    def run(iters):
        for _ in range(iters):
            state[0], state[1] = step(state[0], state[1], step.draw(gen))

    before = dict(cuda.LAUNCHES)
    t0 = time.perf_counter()
    run(1)
    synchronize(device)
    rec["halo_compile_seconds"] = round(time.perf_counter() - t0, 1)
    spi = middle_seconds(run, ITERS, device)
    rec["halo_launches"] = launches_since(before)
    rec["halo_ms_per_iter"] = round(spi * 1e3, 2)
    rec["halo_edges_per_sec"] = round(g_ord.num_edges / spi)
    log(f"halo step: {spi * 1e3:.2f} ms/iter = "
        f"{g_ord.num_edges / spi / 1e6:.0f} M entries/s")
    return spi


def run_replicated(rec, g_ord, params, shape, device, spi=None):
    """Stage 3: the flat tiled step on the same ordered graph."""
    import torch

    from graph_embed_tpu_torch.forceatlas import tiled as TL
    from graph_embed_tpu_torch.ops import cuda

    g_dev = g_ord.to(device)
    t0 = time.perf_counter()
    if shape is not None:
        B, W = shape
        tfa = TL.prepare_tiled(g_dev, 3, params, sender_block=B, window=W,
                               tile=1024)
    else:
        # the reference's shape rule for unit graphs past 1.5M vertices
        tfa = TL.prepare_tiled(g_dev, 3, params)
    synchronize(device)
    rec["replicated_tiles_seconds"] = round(time.perf_counter() - t0, 1)
    rec.update(plan_facts(tfa.csr, "replicated_residual_"))
    rec["replicated_dia_offsets"] = len(tfa.dia_offsets)
    gen = torch.Generator(device=device).manual_seed(1)
    x = torch.rand((g_ord.n, 3), generator=gen, device=device) * 2.0 - 1.0
    state = [x, torch.zeros_like(x)]

    def run(iters):
        for _ in range(iters):
            state[0], state[1] = TL.fa_step_tiled(state[0], state[1], tfa,
                                                  params, generator=gen)

    before = dict(cuda.LAUNCHES)
    t0 = time.perf_counter()
    run(1)
    synchronize(device)
    rec["replicated_compile_seconds"] = round(time.perf_counter() - t0, 1)
    spi_r = middle_seconds(run, ITERS, device)
    rec["replicated_launches"] = launches_since(before)
    rec["replicated_ms_per_iter"] = round(spi_r * 1e3, 2)
    rec["replicated_edges_per_sec"] = round(g_ord.num_edges / spi_r)
    if spi is not None:
        rec["halo_vs_replicated"] = round(spi / spi_r, 2)
    log(f"replicated step: {spi_r * 1e3:.2f} ms/iter = "
        f"{g_ord.num_edges / spi_r / 1e6:.0f} M entries/s")


def main(argv):
    sys.path.insert(0, ROOT)
    from graph_embed_tpu_torch.graph.reorder import (apply_order,
                                                     partition_order)
    from graph_embed_tpu_torch.parallel.halo import build_halo_plan
    from graph_embed_tpu_torch.utils.device import resolve
    from graph_embed_tpu_torch.utils.params import ForceAtlasParams

    args, opts = split_args(argv, device="cuda", out=OUT)
    scale = int(args[0]) if len(args) > 0 else 22
    ef = int(args[1]) if len(args) > 1 else 8
    # optional flat-plan shape override [B W]
    shape = (int(args[2]), int(args[3])) if len(args) > 3 else None
    device, out = resolve(opts["device"]), opts["out"]

    graphs, parts, _ = load_cache(scale, ef)
    g = graphs[0]
    rec = {"workload": f"rmat({scale},{ef}) halo", "n": g.n,
           "edges": g.num_edges, "device": card_label(device)}
    if shape is not None:
        rec["shape"] = list(shape)

    # hierarchy order from the cache (no re-partition)
    t0 = time.perf_counter()
    perm = partition_order(g, levels=parts)
    g_ord, _ = apply_order(g, perm)
    rec["order_seconds"] = round(time.perf_counter() - t0, 1)
    log(f"hierarchy order applied ({rec['order_seconds']}s)")

    xprec = os.environ.get("LJ_X_PRECISION", "f32")
    params = ForceAtlasParams(repulsion="sampled", num_negative_samples=64,
                              x_precision=xprec)
    if xprec != "f32":
        rec["x_precision"] = xprec

    # 1. the 8-shard plan: the comm model on this graph
    t0 = time.perf_counter()
    plan8 = build_halo_plan(g_ord, 8)
    rec["plan8_seconds"] = round(time.perf_counter() - t0, 1)
    rec["plan8_boundary_fraction"] = round(plan8.boundary_fraction, 4)
    rec["plan8_comm_floats_per_step"] = plan8.comm_floats_per_step(3, 64)
    rec["plan8_replicated_comm_floats"] = 2 * plan8.ndev * plan8.blk * 3
    log(f"ndev=8 plan: boundary_fraction={plan8.boundary_fraction:.4f} "
        f"comm {rec['plan8_comm_floats_per_step']:.3e} vs replicated "
        f"{rec['plan8_replicated_comm_floats']:.3e} floats/step")
    del plan8

    # 2. the halo step at one shard (HALO_SCALE_REP_ONLY=1 skips it)
    spi = None
    if not os.environ.get("HALO_SCALE_REP_ONLY"):
        spi = run_halo(rec, g_ord, params, device)
    # 3. the flat tiled step, same ordered graph
    run_replicated(rec, g_ord, params, shape, device, spi)
    print(json.dumps(rec), flush=True)
    with open(out, "a") as f:
        f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
