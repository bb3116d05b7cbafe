"""The full flat FA step at LiveJournal scale on the card: one record per
run (the PyTorch port).

The counterpart of scripts/lj_step_probe.py, with its arguments and record
keys.  ``scale 0`` is community_rmat(512, 22, ef, seed=1) with unit weights
(the com-lj proxy with community structure, generated community-sorted);
any other scale reads the prep cache of scripts/lj_scale_run_torch.py,
orders the fine graph by the cached hierarchy and rebuilds it with unit
weights, as the JAX probe does.  It plans the step with
``prepare_tiled(g, 3, params, sender_block=B, window=W, tile=1024,
min_pair_edges=mpe)`` and times the whole iteration (attraction on kernel
A, then kernel D: sampled repulsion with 64 samples, gravity, swing and
speed): 20 iterations first, then the middle of 3 runs of 20, by CUDA
events.

  python scripts/lj_step_probe_torch.py [scale] [ef] [B] [W] [mpe] \\
      [xprec] [--device d] [--out path]

``LJ_NO_FUSED=1`` forces the unfused branch (``tiled.fused_applies``
patched to False: kernel C for the repulsion, the update in plain torch).
TPU layout keys (fill, overflow) have no meaning on one CSR; the record
holds the plan's DIA offsets and its residual entries, hub rows and
weights instead, and the step's launches.  It is printed and appended to
``--out`` (default ``BENCH_LJ_torch.jsonl``).  ``--device`` defaults to
``cuda`` and raises without a card (``--device cpu``: plain versions).
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from unittest import mock

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from lj_scale_run_torch import (ROOT, card_label, load_cache,  # noqa: E402
                                middle_seconds, plan_facts, split_args,
                                synchronize)

OUT = "BENCH_LJ_torch.jsonl"
ITERS = 20


def probe_graph(scale, ef):
    """(graph on the host, workload name) as the JAX probe builds them."""
    import graph_embed_tpu_torch as gp
    from graph_embed_tpu_torch.graph import synth

    if scale == 0:
        # community_rmat at com-lj's own scale, emitted community-sorted
        gge = synth.cached("community_rmat", 512, 22, ef, seed=1)
        s0, r0, _ = gge.to_coo_numpy()
        g = gp.from_canonical_coo(s0, r0, np.ones(s0.size, np.float32),
                                  gge.n)
        return g, f"community_rmat(512,22,{ef}) full step"
    graphs, parts, _ = load_cache(scale, ef)
    g0 = graphs[0]
    perm = gp.partition_order(g0, levels=parts)
    s0, r0, _ = g0.to_coo_numpy()
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    g = gp.from_edges(inv[s0], inv[r0], np.ones(s0.size, np.float32),
                      n=g0.n, symmetrize=False)
    return g, f"rmat({scale},{ef}) ordered full step"


def probe(g, workload, B, W, mpe, xprec, device):
    """Plan and time the step on ``g``; returns the record."""
    import torch

    from graph_embed_tpu_torch.forceatlas import tiled as TL
    from graph_embed_tpu_torch.ops import cuda
    from graph_embed_tpu_torch.utils.params import ForceAtlasParams

    E = g.num_edges
    print(f"{workload}: n={g.n} E={E}", flush=True)
    params = ForceAtlasParams(repulsion="sampled", num_negative_samples=64,
                              x_precision=xprec)
    g_dev = g.to(device)
    t0 = time.perf_counter()
    tfa = TL.prepare_tiled(g_dev, 3, params, sender_block=B, window=W,
                           tile=1024, min_pair_edges=mpe)
    synchronize(device)
    tiles_s = round(time.perf_counter() - t0, 1)
    facts = plan_facts(tfa.csr, "residual_")
    print(f"plan: dia_offsets={len(tfa.dia_offsets)} residual "
          f"entries={facts['residual_entries']} hub rows="
          f"{facts['residual_hub_rows']} ({tiles_s}s)", flush=True)

    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.rand((g.n, 3), generator=gen, device=device) * 2.0 - 1.0
    state = [x, torch.zeros_like(x)]

    def run(iters):
        for _ in range(iters):
            state[0], state[1] = TL.fa_step_tiled(state[0], state[1], tfa,
                                                  params, generator=gen)

    before = dict(cuda.LAUNCHES)
    t0 = time.perf_counter()
    run(ITERS)
    synchronize(device)
    first_s = time.perf_counter() - t0
    spi = middle_seconds(run, ITERS, device)
    launches = {k: v - before.get(k, 0) for k, v in cuda.LAUNCHES.items()
                if v != before.get(k, 0)}
    return {"ts": time.strftime("%Y-%m-%d %H:%M:%S"),
            "workload": workload,
            "n": g.n, "edges": E, "shape": [B, W],
            "dia_offsets": len(tfa.dia_offsets), **facts,
            "fused": TL.fused_applies(tfa, params),
            "ms_per_iter": round(spi * 1e3, 2),
            "edges_per_sec": round(E / spi),
            "vs_1e9": round(E / spi / 1e9, 3),
            "min_pair_edges": mpe, "x_precision": xprec,
            "first_block_seconds": round(first_s, 1),
            "tiles_seconds": tiles_s, "launches": launches,
            "device": card_label(device)}


def main(argv):
    sys.path.insert(0, ROOT)
    from graph_embed_tpu_torch.forceatlas import tiled as TL
    from graph_embed_tpu_torch.utils.device import resolve

    args, opts = split_args(argv, device="cuda", out=OUT)
    scale = int(args[0]) if len(args) > 0 else 22
    ef = int(args[1]) if len(args) > 1 else 8
    B = int(args[2]) if len(args) > 2 else 8192
    W = int(args[3]) if len(args) > 3 else 8192
    mpe = int(args[4]) if len(args) > 4 else 0   # min_pair_edges
    xprec = args[5] if len(args) > 5 else "f32"
    device, out = resolve(opts["device"]), opts["out"]
    g, workload = probe_graph(scale, ef)
    # LJ_NO_FUSED: A/B the unfused branch (kernel C, the update in torch)
    with (mock.patch.object(TL, "fused_applies", lambda tfa, params: False)
          if os.environ.get("LJ_NO_FUSED") else contextlib.nullcontext()):
        rec = probe(g, workload, B, W, mpe, xprec, device)
    print(json.dumps(rec), flush=True)
    with open(out, "a") as f:
        f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
