"""Traffic driver ``flat``: the flat tiled ForceAtlas iteration of the
port (``forceatlas.tiled.fa_step_tiled`` over ``prepare_tiled``'s plan,
kernels A and D) driven back to back for the window.

Set-up: the graph drawn on the device, handed to the program as a
card-only ``Graph``, planned by ``prepare_tiled`` at the port's default
plan; the start U(-1, 1)^dim and every step's sample ids drawn from one
``torch.Generator`` on the device; ``warmup_iterations`` steps, which
build and load the kernel library.  Window: steps until ``--seconds``
have passed, the last one closed by a synchronize; the rate is the
graph's stored entries times the steps over the whole window.

Check, after the window and with the program's plan freed: three steps
of the window (the last, and two drawn from the seed among the first 256,
copied aside as they pass) are held to the plain reference
(``reference/flat_step.py``): the forces f over every element against
the reference's at the same x and sample ids, and x' against the
reference's x' from its own forces, each gap over the element's scale
(the sum of its terms' magnitudes; for x' the magnitude of x plus the
force scale times the speed).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from portbench import harness, trace as TR
from portbench.program import program_graph, sync


def run(ctx: harness.Context) -> harness.Run:
    from graph_embed_tpu_torch.forceatlas import tiled as TL
    from graph_embed_tpu_torch.utils.params import ForceAtlasParams

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = ctx.traffic
    fa = t["force_atlas"]
    dim, samples = int(t["dim"]), int(t["samples"])
    dev = torch.device(ctx.device)
    arrays = ctx.graph()
    n, nnz = arrays["n"], int(arrays["senders"].shape[0])
    g = program_graph(arrays)
    del arrays
    harness.note(ctx, f"graph n={n} entries={nnz}")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    params = ForceAtlasParams(repulsion="sampled",
                              num_negative_samples=samples,
                              x_precision=t["x_precision"], **fa)
    tfa = TL.prepare_tiled(g, dim, params)
    plan = {"dia_offsets": len(tfa.dia_offsets),
            "residual_nnz": 0 if tfa.csr is None else int(tfa.csr.nnz)}
    harness.note(ctx, f"planned {plan}")
    gen = torch.Generator(device=dev).manual_seed(
        harness.derive_seed(ctx.seed, 1))
    x = torch.rand((n, dim), generator=gen, device=dev) * 2.0 - 1.0
    f = torch.zeros_like(x)

    def step(x, f):
        idx = torch.randint(0, n, (samples,), generator=gen, device=dev,
                            dtype=torch.int32)
        x2, f2 = TL.fa_step_tiled(x, f, tfa, params, sample_idx=idx)
        return idx, x2, f2

    for _ in range(int(t["warmup_iterations"])):
        _, x, f = step(x, f)
    sync(dev)
    picks = sorted(np.random.default_rng(ctx.seed).choice(
        256, size=2, replace=False).tolist())
    # the picked steps are copied into buffers made before the window, so
    # which steps a seed picks leaves the window's allocations alone
    bufs = [tuple(torch.empty_like(a) for a in (x, f, x, f)) + (
        torch.empty(samples, dtype=torch.int32, device=dev),)
        for _ in picks]
    kept = {}
    with TR.profile(dev) if ctx.trace else contextlib.nullcontext() as prof:
        t_setup = time.perf_counter()
        setup_s = t_setup - ctx.t0
        it = 0
        while True:
            idx, x2, f2 = step(x, f)
            if it in picks:
                b = bufs[picks.index(it)]
                for dst, src in zip(b, (x, f, x2, f2, idx)):
                    dst.copy_(src)
                kept[it] = (b[0], b[1], b[4], b[2], b[3])
            last = (x, f, idx, x2, f2)
            x, f = x2, f2
            it += 1
            if time.perf_counter() - t_setup >= ctx.seconds:
                break
        sync(dev)
        window_s = time.perf_counter() - t_setup
    kept[it - 1] = last
    harness.note(ctx, f"window {it} iterations in {window_s} s")
    record = {"n": n, "nnz": nnz, "dim": dim, "samples": samples,
              "iterations": it, "window_s": window_s, "plan": plan}
    busy_s = breakdown = None
    if prof is not None:
        red = TR.reduce(TR.device_intervals(prof))
        del prof
        busy_s = red["busy_s"]
        record["trace"] = {"busy_s": busy_s, "kernels": red["kernels"]}
        breakdown = {"device_ops": TR.top((k, v["seconds"]) for k, v in
                                          red["kernels"].items()),
                     "idle_gaps": TR.top(red["gaps"])}
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    del tfa, g, x, f, x2, f2, last
    checks, failed = check_steps(ctx, kept)
    harness.note(ctx, "checked")
    return harness.Run(end_to_end={"fa_entries_per_s": nnz * it / window_s,
                                   "setup_s": setup_s},
                       attempted=it, failed=failed, checks=checks,
                       memory_peak_bytes=peak, record=record, busy_s=busy_s,
                       window_s=window_s, breakdown=breakdown)


def check_steps(ctx: harness.Context, kept: dict):
    """The worst force and step gaps over the kept steps, against the
    plain reference on the graph drawn again from the seed; and how many
    of the kept steps passed a limit."""
    from portbench.reference import flat_step as REF

    fa = ctx.traffic["force_atlas"]
    limits = ctx.traffic["limits"]
    arrays = ctx.graph()
    s, r, n = arrays["senders"], arrays["receivers"], arrays["n"]
    seen = {"force_gap": [], "step_gap": []}
    failed = 0
    for _, (x, f_prev, idx, x_out, f_out) in sorted(kept.items()):
        f_ref, scale = REF.forces(
            s, r, n, x, idx, repel=fa["repel"], attract=fa["attract"],
            gravity=fa["gravity"], eps=fa["epsilon"])
        x_ref, speed = REF.update(x, f_ref, f_prev, ks=fa["ks"],
                                  ksmax=fa["ksmax"],
                                  tolerate=fa["tolerate"])
        gaps = {"force_gap": harness.gap(f_out, f_ref, scale),
                "step_gap": harness.gap(
                    x_out, x_ref,
                    x.to(torch.float64).abs() + scale * speed[:, None])}
        failed += any(not gaps[k] <= limits[k] for k in gaps)
        for k, v in gaps.items():
            seen[k].append(v)
    return ([harness.Check(k, harness.worst(*v), limits[k])
             for k, v in seen.items()], failed)
