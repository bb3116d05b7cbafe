"""Traffic driver ``embed``: whole multilevel embeds of the port
(``embed.driver.embed_graph`` on a graph that lives only on the card: the
device coarsener, ``build_galerkin_chain``, the base case, then per level
the radii, the host layout prep and the slot-space refinement), back to
back for the window.

Set-up: the graph drawn on the device and handed to the program as a
card-only ``Graph``; one embed of the traffic's small warm-up graph, which
builds and loads the kernel libraries.  Window: embeds back to back, each
with its own seed drawn from the run's; every embed that starts before
``--seconds`` have passed runs to its end and counts; ``embed_s`` is their
summed seconds over their count.  Each embed reports its spans through
the benchmark's ``MetricsLogger``.  A traced run adds one embed once the
window has closed, each of its spans under its own profiler (reading a
profile takes longer than the embed, so a traced embed inside the window
would crowd the others out).

Check, after the window: one embed, drawn from the seed among the first
three (the last where the window held fewer), is held stage by stage to
the plain reference (``reference/hierarchy.py``, ``reference/embed.py``),
each stage from the inputs the program's stage had:

* ``hierarchy_mismatch``: vertices whose aggregate differs from the
  reference coarsener's, over every level (exact: limit 0);
* ``base_gap``: the base case's layout against the reference's from the
  same start, max |difference| over the layout's extent;
* ``radii_gap``: each level's renormalized centres and radii against the
  reference's from the program's previous level, max over aggregates of
  (|centre difference| + |radius difference|) / radius;
* ``refine_gap``: each level's refined coordinates (level 0's are the
  embed's result) against the reference's from the same parent balls and
  start: the traffic's ``refine_quantile`` of |difference| / parent
  radius over the level's vertices, the largest over the levels;
* ``refine_worst``: the same gap's maximum over every vertex.  It follows
  the few aggregates whose 100 iterations part ways in float32 and
  float64, so only a vertex placed outside the ball the reference gives
  it reads far above 2 (two layouts inside one ball differ by at most
  its diameter).

The traffic's ``reference_dtype`` (the control) puts the reference,
computed in that precision, in the program's place.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from portbench import harness
from portbench.program import program_graph, span_logger, sync


def run(ctx: harness.Context) -> harness.Run:
    from graph_embed_tpu_torch.embed.driver import embed_graph

    t = ctx.traffic
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(ctx.device)
    kw = dict(coarsening_factor=t["coarsening_factor"],
              refine_iterations=t["refine_iterations"])
    dim = int(t["dim"])
    arrays = ctx.graph()
    g = program_graph(arrays)
    n, nnz = arrays["n"], int(arrays["senders"].shape[0])
    del arrays
    harness.note(ctx, f"graph n={n} entries={nnz}")
    gen = harness.load_module(ctx.root, "generators",
                              t["warmup_graph"]["generator"])
    gw = program_graph(gen.build(t["warmup_graph"], 0, dev))
    embed_graph(gw, dim, device=dev, seed=0,
                base_iterations=t["warmup_base_iterations"], **kw)
    sync(dev)
    del gw
    harness.note(ctx, "warmed up")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    pick = int(np.random.default_rng(ctx.seed).integers(0, 3))
    embeds, kept = [], {}
    t_setup = time.perf_counter()
    setup_s = t_setup - ctx.t0
    while time.perf_counter() - t_setup < ctx.seconds:
        i = len(embeds)
        embeds.append(one_embed(embed_graph, g, dim, dev, kw,
                                harness.derive_seed(ctx.seed, 100 + i),
                                traced=False))
        harness.note(ctx, f"embed {i}: {embeds[-1]['seconds']} s")
        if i <= pick:
            kept = embeds[-1].pop("kept")
        embeds[-1].pop("kept", None)
    window_s = time.perf_counter() - t_setup
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    if ctx.trace:
        # one more embed, profiled span by span, once the window has
        # closed: its spans' device time is the traced window
        embeds.append(one_embed(embed_graph, g, dim, dev, kw,
                                harness.derive_seed(ctx.seed, 99),
                                traced=True))
        embeds[-1].pop("kept")
        harness.note(ctx, f"traced embed: {embeds[-1]['seconds']} s")
    kept["levels"] = {l: tuple(a.cpu().numpy() for a in v)
                      for l, v in kept["levels"].items()}
    kept["parts"] = [p.vertex_to_agg_numpy() for p in kept["parts"]]
    del g
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    record = {"embeds": [{"seconds": e["seconds"], "traced": e["traced"],
                          "spans": [{k: v for k, v in sp.items()
                                     if k != "kernels"} for sp in e["spans"]]}
                         for e in embeds]}
    busy_s = breakdown = None
    if ctx.trace and dev.type == "cuda":
        busy_s, window_s, breakdown, kernels = _trace_totals(embeds[-1])
        record["trace"] = {"busy_s": busy_s, "window_s": window_s,
                           "kernels": kernels}
    checks = check_embed(ctx, kept)
    harness.note(ctx, "checked")
    timed = [e["seconds"] for e in embeds if not e["traced"]]
    return harness.Run(
        end_to_end={"embed_s": sum(timed) / len(timed), "setup_s": setup_s},
        attempted=len(timed), failed=int(not all(c.ok for c in checks)),
        checks=checks, memory_peak_bytes=peak, record=record, busy_s=busy_s,
        window_s=window_s, breakdown=breakdown)


def one_embed(embed_graph, g, dim, dev, kw, seed, traced):
    """One whole embed: {"seconds", "traced", "spans", "kept"}, ``kept``
    holding what the check needs (its seed, each level's outputs on the
    device, its partitions)."""
    levels = {}

    def on_level(l, coords, part, coords_A, r_A):
        levels[l] = tuple(a.detach().clone() for a in (coords, coords_A, r_A))

    log = span_logger(dev, traced)
    t0 = time.perf_counter()
    _, res = embed_graph(g, dim, device=dev, seed=seed, metrics=log,
                         on_level=on_level, **kw)
    sync(dev)
    return {"seconds": time.perf_counter() - t0, "traced": traced,
            "spans": log.records,
            "kept": {"seed": seed, "levels": levels, "parts": res.levels}}


def _trace_totals(embed):
    """The traced embed's (busy seconds: the card's, over its spans;
    window seconds: its spans' host seconds, which leave out the
    profiler's own reading between spans; the breakdown; each kernel's
    calls and seconds)."""
    from portbench import trace as TR

    busy, window, idle, kernels = 0.0, 0.0, [], {}
    for sp in embed["spans"]:
        busy += sp["busy_s"]
        window += sp["seconds"]
        idle.append((sp["phase"], sp["seconds"] - sp["busy_s"]))
        for name, k in sp["kernels"].items():
            tot = kernels.setdefault(name, {"calls": 0, "seconds": 0.0})
            tot["calls"] += k["calls"]
            tot["seconds"] += k["seconds"]
    breakdown = {"device_ops": TR.top((k, v["seconds"])
                                      for k, v in kernels.items()),
                 "idle_gaps": TR.top(idle)}
    return busy, window, breakdown, kernels


def check_embed(ctx: harness.Context, kept: dict) -> list:
    from portbench.reference import embed as E
    from portbench.reference import hierarchy as H

    t = ctx.traffic
    fa = t["force_atlas"]
    dtype = getattr(torch, t.get("reference_dtype", "float64"))
    control = dtype != torch.float64
    arrays = ctx.graph()
    dev = arrays["senders"].device
    s = arrays["senders"].cpu().numpy()
    r = arrays["receivers"].cpu().numpy()
    n = arrays["n"]
    del arrays
    ref_parts = H.hierarchy(s, r, np.ones(s.size, np.float32), n,
                            t["coarsening_factor"])
    parts = kept["parts"]
    mismatch = 0 if control else _mismatch(ref_parts, parts, n)
    if mismatch == 0:
        parts = ref_parts
    chain = [(s, r, np.ones(s.size), n)]
    for v2a in parts:
        m = int(v2a.max()) + 1
        chain.append((*H.galerkin(*chain[-1][:3], v2a, m), m))
    k = len(parts)
    seeds = E.level_seeds(kept["seed"], k)
    lv = kept["levels"]
    cs, cr, cw, m = chain[k]
    x0 = E.uniform_start(m, int(t["dim"]), seeds[k], dev)
    iters = min(t["base_iterations_cap"],
                max(t["base_iterations_floor"],
                    t["base_iterations_per_vertex"] * m))
    want = E.base_case(cs, cr, cw, m, x0, iters, fa).cpu()
    got = (E.base_case(cs, cr, cw, m, x0, iters, fa, dtype=dtype).cpu()
           if control else torch.from_numpy(lv[k - 1][1]))
    base_gap = harness.gap(got, want, want.abs().max())
    radii_gap = refine_gap = refine_worst = 0.0
    for l in range(k - 1, -1, -1):
        coords_l, cA, rA = lv[l]
        if l == k - 1:
            c_in = lv[l][1]
            r_want = E.radii_top(c_in.astype(np.float32))
            c_want = torch.from_numpy(c_in).double()
            r_got = (E.radii_top(_round(c_in, dtype)) if control else rA)
            c_got = c_want if control else torch.from_numpy(cA)
        else:
            c_in, r_par, c_par = lv[l + 1][0], lv[l + 1][2], lv[l + 1][1]
            s1, r1 = chain[l + 1][0], chain[l + 1][1]
            rr = E.radii_inner(c_in.astype(np.float32), r_par, s1, r1,
                               parts[l + 1])
            c_want, r_want = E.renormalize(c_in, rr, c_par, r_par,
                                           parts[l + 1])
            if control:
                rr = E.radii_inner(_round(c_in, dtype), r_par, s1, r1,
                                   parts[l + 1])
                c_got, r_got = E.renormalize(_round(c_in, dtype), rr, c_par,
                                             r_par, parts[l + 1])
            else:
                c_got, r_got = torch.from_numpy(cA), rA
        r_want = torch.as_tensor(r_want, dtype=torch.float64)
        c_want = torch.as_tensor(c_want, dtype=torch.float64)
        radii_gap = harness.worst(
            radii_gap, harness.gap(r_got, r_want, r_want),
            harness.gap(c_got, c_want, c_want.abs().max()))
        s_l, r_l, w_l, _ = chain[l]
        rows, n_rows = E.slot_rows(parts[l], int(parts[l].max()) + 1)
        x0 = E.uniform_start(n_rows, int(t["dim"]), seeds[l], dev)[
            torch.from_numpy(rows).to(dev)]
        want = E.refine(s_l, r_l, w_l, parts[l], cA, rA, x0, fa,
                        t["refine_iterations"]).cpu()
        got = (E.refine(s_l, r_l, w_l, parts[l], cA, rA, x0, fa,
                        t["refine_iterations"], dtype=dtype).cpu()
               if control else torch.from_numpy(coords_l))
        scale = torch.as_tensor(rA, dtype=torch.float64)[
            torch.from_numpy(parts[l])]
        per = ((got.double() - want).abs().amax(1)
               / torch.clamp(scale, min=1e-30))
        q = float(np.quantile(per.numpy(), t["refine_quantile"]))
        refine_gap = harness.worst(refine_gap, q)
        refine_worst = harness.worst(refine_worst, float(per.max()))
        print(f"portbench: level {l} n={per.numel()} refine gap q"
              f"{t['refine_quantile']} {q!r} max {float(per.max())!r} "
              f"median {float(per.median())!r}", file=sys.stderr)
    lim = t["limits"]
    return [harness.Check("hierarchy_mismatch", mismatch,
                          lim["hierarchy_mismatch"]),
            harness.Check("base_gap", base_gap, lim["base_gap"]),
            harness.Check("radii_gap", radii_gap, lim["radii_gap"]),
            harness.Check("refine_gap", refine_gap, lim["refine_gap"]),
            harness.Check("refine_worst", refine_worst,
                          lim["refine_worst"])]


def _mismatch(ref_parts, parts, n: int) -> int:
    """Vertices, over every level, whose aggregate differs (a level one
    side lacks counts whole)."""
    out = 0
    for l in range(max(len(ref_parts), len(parts))):
        if l >= len(ref_parts) or l >= len(parts) or \
                ref_parts[l].size != parts[l].size:
            out += n if l == 0 else (parts[l] if l < len(parts)
                                     else ref_parts[l]).size
            continue
        out += int((ref_parts[l] != parts[l]).sum())
    return out


def _round(c: np.ndarray, dtype) -> np.ndarray:
    """``c`` rounded to ``dtype`` and back to float32."""
    return torch.from_numpy(np.asarray(c, np.float32)).to(dtype).to(
        torch.float32).numpy()

