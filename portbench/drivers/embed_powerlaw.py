"""Traffic driver ``embed-powerlaw``: whole multilevel embeds of the port at
``embed_graph``'s defaults on a power-law graph that lives only on the
card, where the slot-space refinement meets hub aggregates: those of
``sampled_slots_threshold`` slots or more take the sampled
within-aggregate estimator (the program's ``slot.sampled`` sub-spans),
the rest kernel B over skewed size classes.

Set-up, window, ``embed_s`` and ``setup_s`` are ``embed.py``'s own loop,
loaded and run as it stands, with this driver's span logger and check in
its place: the graph drawn on the device, one embed of the traffic's
warm-up graph, then embeds back to back, each with its own seed; every
embed that starts before ``--seconds`` have passed runs to its end and
counts.  Each embed's phase seconds are printed on standard error.  A
traced run adds one embed once the window has closed, each of its phase
spans under its own profiler; in it each ``refine`` span also keeps
``sampled``, the card's seconds and calls of the work launched inside
the program's ``slot.sampled`` sub-spans (``embed_linlog
.launched_inside``), and ``kernel_b``, kernel B's calls and seconds in
the span.

Check, after the window, as ``embed.py``'s: one embed, drawn from the
seed among the first three, held stage by stage to the plain reference,
each stage from the inputs the program's stage had:
``hierarchy_mismatch`` (``reference/hierarchy.py``, its hierarchy kept
per checkout as ``embed_linlog.reference_hierarchy`` keeps it),
``base_gap``, ``radii_gap`` (``reference/embed.py``), ``refine_gap`` and
``refine_worst`` against ``reference/embed_sampled.py``: exact pairs below
the threshold, the estimator on the program's uniforms above it.  The
traffic's ``reference_dtype`` (the control) puts the reference, computed
in that precision, in the program's place.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time

import numpy as np
import torch

from portbench import harness
from portbench import trace as TR
from portbench.drivers.embed import _mismatch, _round
from portbench.drivers.embed_linlog import launched_inside, \
    reference_hierarchy
from portbench.program import sync


def run(ctx: harness.Context) -> harness.Run:
    loop = harness.load_module(ctx.root, "drivers", "embed")
    loop.span_logger = span_logger
    loop.check_embed = check_powerlaw
    out = loop.run(ctx)
    t = ctx.traffic
    out.record.update(dim=int(t["dim"]), samples=int(t["samples"]),
                      refine_iterations=int(t["refine_iterations"]))
    for i, e in enumerate(out.record["embeds"]):
        phases = {}
        for sp in e["spans"]:
            phases[sp["phase"]] = phases.get(sp["phase"], 0.0) + sp[
                "seconds"]
        harness.note(ctx, "phases " + json.dumps(
            {"embed": i, "traced": e["traced"], "seconds": e["seconds"],
             **phases}))
    return out


def span_logger(device, traced: bool):
    """``program.span_logger``'s logger, whose traced spans also keep the
    card's seconds and calls of the work launched inside ``slot.sampled``
    sub-spans (``sampled``) and of kernel B (``kernel_b``)."""
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
                if "bucket_repulsion" in red["kernels"]:
                    extra["kernel_b"] = red["kernels"]["bucket_repulsion"]
                windows = [(sub["t0_ns"], sub["t1_ns"]) for sub in self._sub
                           if sub["name"] == "slot.sampled"]
                if windows:
                    extra["sampled"] = launched_inside(prof, windows)
            self.log(phase=phase, seconds=seconds, **fields, **extra)

    return SpanLogger()


def check_powerlaw(ctx: harness.Context, kept: dict) -> list:
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
    want = E.base_case(cs, cr, cw, m, x0, iters, fa).cpu()
    got = (E.base_case(cs, cr, cw, m, x0, iters, fa, dtype=dtype).cpu()
           if control else torch.from_numpy(lv[k - 1][1]))
    base_gap = harness.gap(got, want, want.abs().max())
    harness.note(ctx, "reference base case")
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
        q, worst = refine_gaps(chain[l][:3], parts[l], cA, rA, seeds[l],
                               t, dev, dtype, None if control else coords_l)
        refine_gap = harness.worst(refine_gap, q)
        refine_worst = harness.worst(refine_worst, worst)
        print(f"portbench: level {l} n={parts[l].size} refine gap q"
              f"{t['refine_quantile']} {q!r} max {worst!r}",
              file=sys.stderr)
        harness.note(ctx, f"reference level {l}")
    lim = t["limits"]
    return [harness.Check("hierarchy_mismatch", mismatch,
                          lim["hierarchy_mismatch"]),
            harness.Check("base_gap", base_gap, lim["base_gap"]),
            harness.Check("radii_gap", radii_gap, lim["radii_gap"]),
            harness.Check("refine_gap", refine_gap, lim["refine_gap"]),
            harness.Check("refine_worst", refine_worst,
                          lim["refine_worst"])]


def refine_gaps(graph, v2a, cA, rA, seed: int, t: dict, dev, dtype,
                got=None) -> tuple[float, float]:
    """(the traffic's ``refine_quantile``, the largest) of |coordinate
    difference| / parent radius over one level's vertices, between the
    float64 reference's refinement of the level (``graph`` = (s, r, w))
    and ``got`` [n, d] (the program's), or the reference's in ``dtype``
    where ``got`` is None."""
    from portbench.reference import embed_sampled as R

    kw = dict(threshold=int(t["sampled_slots_threshold"]),
              samples=int(t["samples"]), device=dev)
    args = (*graph, v2a, cA, rA, seed, int(t["dim"]), t["force_atlas"],
            int(t["refine_iterations"]))
    want = R.refine(*args, **kw).cpu()
    got = (R.refine(*args, **kw, dtype=dtype).cpu() if got is None
           else torch.as_tensor(got))
    scale = torch.as_tensor(rA, dtype=torch.float64)[torch.from_numpy(
        np.asarray(v2a))]
    per = ((got.double() - want).abs().amax(1)
           / torch.clamp(scale, min=1e-30))
    return (float(np.quantile(per.numpy(), t["refine_quantile"])),
            float(per.max()))
