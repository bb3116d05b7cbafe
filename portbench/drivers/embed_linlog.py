"""Traffic driver ``embed-linlog``: whole multilevel embeds of the port in
ForceAtlas2's LinLog mode (``embed.driver.embed_graph`` with
``ForceAtlasParams(linlog=True)`` and ``MultilevelFAParams(linlog=True)``
on a graph that lives only on the card: the device coarsener,
``build_galerkin_chain``, the base case with kernel E's log attraction,
then per level the radii and the portable refinement, whose host prep
builds the member tables and the intra-aggregate CSR and whose loop runs
the gram repulsion and kernel E), back to back for the window.

Set-up, window and ``embed_s``/``setup_s`` are ``embed.py``'s: the graph
drawn on the device, one LinLog embed of the traffic's small warm-up
graph, then embeds back to back, each with its own seed; every embed
that starts before ``--seconds`` have passed runs to its end and counts.
A traced run adds one embed once the window has closed, each of its
phase spans under its own profiler; in it the card's time of the
kernels launched inside the program's ``ml.repulsion`` sub-spans (found
by the launch's correlation id and its host stamp) is kept on each
``refine`` span as ``repulsion``.

Check, after the window, as ``embed.py`` does: one embed, drawn from the
seed among the first three, held stage by stage to the plain reference
(``reference/hierarchy.py``, ``reference/embed.py``'s radii and
renormalization, ``reference/embed_linlog.py``), each stage from the
inputs the program's stage had: ``hierarchy_mismatch``, ``base_gap``,
``radii_gap``, ``refine_gap`` and ``refine_worst`` as there, with the
LinLog base case, the coarsest radii over the coarsest graph's edges
above 512 aggregates, and the portable refinement's start (row i for
vertex i).

The traffic's ``reference_dtype`` (the control) puts the reference,
computed in that precision, in the program's place.

The reference hierarchy depends on the graph alone, which the
configuration fixes; it is computed once per checkout and kept under
``portbench/_cache/``, named by a hash of the configuration, the
coarsening factor and the sources of the generator and of
``reference/hierarchy.py``.
"""

from __future__ import annotations

import bisect
import contextlib
import hashlib
import json
import os
import sys
import time

import numpy as np
import torch

from portbench import harness
from portbench import trace as TR
from portbench.drivers.embed import _mismatch, _round, _trace_totals
from portbench.program import program_graph, sync

#: the names of the host calls that enqueue work on the card
_LAUNCHES = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset",
             "cudaGraphLaunch")


def run(ctx: harness.Context) -> harness.Run:
    from graph_embed_tpu_torch.embed.driver import embed_graph
    from graph_embed_tpu_torch.utils.params import (ForceAtlasParams,
                                                    MultilevelFAParams)

    t = ctx.traffic
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(ctx.device)
    kw = dict(coarsening_factor=t["coarsening_factor"],
              refine_iterations=t["refine_iterations"],
              base_params=ForceAtlasParams(linlog=True),
              refine_params=MultilevelFAParams(linlog=True))
    dim = int(t["dim"])
    arrays = ctx.graph()
    g = program_graph(arrays)
    n, nnz = arrays["n"], int(arrays["senders"].shape[0])
    del arrays
    harness.note(ctx, f"graph n={n} entries={nnz}")
    wcfg = t["warmup_graph"]
    gen = harness.load_module(ctx.root, "generators", wcfg["generator"])
    gw = program_graph(gen.build(wcfg, 0, dev))
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
    record = {"dim": dim,
              "embeds": [{"seconds": e["seconds"], "traced": e["traced"],
                          "spans": [{k: v for k, v in sp.items()
                                     if k != "kernels" or e["traced"]}
                                    for sp in e["spans"]]}
                         for e in embeds]}
    busy_s = breakdown = None
    if ctx.trace and dev.type == "cuda":
        busy_s, window_s, breakdown, kernels = _trace_totals(embeds[-1])
        record["trace"] = {"busy_s": busy_s, "window_s": window_s,
                           "kernels": kernels}
    checks = check_linlog(ctx, kept)
    harness.note(ctx, "checked")
    timed = [e["seconds"] for e in embeds if not e["traced"]]
    return harness.Run(
        end_to_end={"embed_s": sum(timed) / len(timed), "setup_s": setup_s},
        attempted=len(timed), failed=int(not all(c.ok for c in checks)),
        checks=checks, memory_peak_bytes=peak, record=record, busy_s=busy_s,
        window_s=window_s, breakdown=breakdown)


def one_embed(embed_graph, g, dim, dev, kw, seed, traced):
    """``embed.one_embed`` with this driver's logger: {"seconds",
    "traced", "spans", "kept"}, ``kept`` holding what the check needs (its
    seed, each level's outputs on the device, its partitions)."""
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


def span_logger(device, traced: bool):
    """``program.span_logger``'s logger, whose traced spans also keep, on
    a span with ``ml.repulsion`` sub-spans, the card's seconds and calls
    of the work launched inside them (``repulsion``)."""
    from graph_embed_tpu_torch.utils.timing import MetricsLogger

    class SpanLogger(MetricsLogger):
        @contextlib.contextmanager
        def span(self, phase, device=None, **fields):
            if not traced:
                with super().span(phase, device, **fields):
                    yield
                return
            with TR.profile(device or "cpu") as prof:
                t0 = time.perf_counter()
                yield
                sync(device or "cpu")
                seconds = time.perf_counter() - t0
            extra = {}
            if prof is not None:
                red = TR.reduce(TR.device_intervals(prof))
                extra = {"busy_s": red["busy_s"], "kernels": red["kernels"]}
                windows = [(sub["t0_ns"], sub["t1_ns"]) for sub in self._sub
                           if sub["name"] == "ml.repulsion"]
                if windows:
                    extra["repulsion"] = launched_inside(prof, windows)
            self.log(phase=phase, seconds=seconds, **fields, **extra)

    return SpanLogger()


def launched_inside(prof, windows) -> dict:
    """{"seconds", "calls"}: the card's seconds and count of the device
    activities whose launch (the host call with the same correlation id)
    started inside one of ``windows`` [(t0_ns, t1_ns)]."""
    launch, device = {}, []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            device.append(e)
        elif e.name().startswith(_LAUNCHES):
            launch[e.correlation_id()] = e.start_ns()
    windows = sorted(windows)
    starts = [w[0] for w in windows]
    seconds, calls = 0.0, 0
    for e in device:
        at = launch.get(e.correlation_id())
        if at is None:
            continue
        i = bisect.bisect_right(starts, at) - 1
        if i >= 0 and at <= windows[i][1]:
            seconds += e.duration_ns() * 1e-9
            calls += 1
    return {"seconds": seconds, "calls": calls}


def reference_hierarchy(ctx: harness.Context, H, s, r, n: int) -> list:
    """``H.hierarchy`` of the configuration's graph (s, r, n), from the
    checkout's cache when an earlier run computed it (see the module's
    doc), else computed and kept there."""
    key = hashlib.sha256(json.dumps(
        [ctx.cell.config, ctx.traffic["coarsening_factor"]],
        sort_keys=True).encode())
    for kind, name in (("generators", ctx.cell.config["generator"]),
                       ("reference", "hierarchy")):
        with open(os.path.join(ctx.root, "portbench", kind,
                               f"{name}.py"), "rb") as fh:
            key.update(fh.read())
    path = os.path.join(ctx.root, "portbench", "_cache",
                        f"hierarchy-{key.hexdigest()[:24]}.npz")
    if os.path.isfile(path):
        with np.load(path) as z:
            return [z[f"level{i}"] for i in range(len(z.files))]
    parts = H.hierarchy(s, r, np.ones(s.size, np.float32), n,
                        ctx.traffic["coarsening_factor"])
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.npz"
    np.savez(tmp, **{f"level{i}": p for i, p in enumerate(parts)})
    os.replace(tmp, path)
    return parts


def check_linlog(ctx: harness.Context, kept: dict) -> list:
    from portbench.reference import embed as E
    from portbench.reference import embed_linlog as L
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
    ref_parts = reference_hierarchy(ctx, H, s, r, n)
    harness.note(ctx, "reference hierarchy")
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
    want = L.base_case(cs, cr, cw, m, x0, iters, fa).cpu()
    got = (L.base_case(cs, cr, cw, m, x0, iters, fa, dtype=dtype).cpu()
           if control else torch.from_numpy(lv[k - 1][1]))
    base_gap = harness.gap(got, want, want.abs().max())
    harness.note(ctx, "reference base case")
    radii_gap = refine_gap = refine_worst = 0.0
    for l in range(k - 1, -1, -1):
        coords_l, cA, rA = lv[l]
        if l == k - 1:
            c_in = lv[l][1]
            r_want = L.radii_top(c_in.astype(np.float32), cs, cr)
            c_want = torch.from_numpy(c_in).double()
            r_got = (L.radii_top(_round(c_in, dtype), cs, cr) if control
                     else rA)
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
        s_l, r_l, w_l, n_l = chain[l]
        x0 = E.uniform_start(n_l, int(t["dim"]), seeds[l], dev)
        want = L.refine(s_l, r_l, w_l, parts[l], cA, rA, x0, fa,
                        t["refine_iterations"]).cpu()
        got = (L.refine(s_l, r_l, w_l, parts[l], cA, rA, x0, fa,
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
        harness.note(ctx, f"reference level {l}")
    lim = t["limits"]
    return [harness.Check("hierarchy_mismatch", mismatch,
                          lim["hierarchy_mismatch"]),
            harness.Check("base_gap", base_gap, lim["base_gap"]),
            harness.Check("radii_gap", radii_gap, lim["radii_gap"]),
            harness.Check("refine_gap", refine_gap, lim["refine_gap"]),
            harness.Check("refine_worst", refine_worst,
                          lim["refine_worst"])]
