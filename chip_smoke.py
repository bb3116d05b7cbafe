#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card.

    python3 chip_smoke.py

Phases, one JSON line each:
  env       the card (nvidia-smi name and power limit), torch and CUDA
            versions; TF32 matmuls must be off (the gram repulsion needs
            full-float32 products);
  build     nvcc build of graph_embed_tpu_torch/csrc and its seconds;
  setup     mesh3d(128) and its hierarchy; the flat step's two graphs
            (bench.py:50-73): mesh3d(128) in natural order and rmat(20, 8,
            seed=1) with unit weights, each planned by ``prepare_tiled``
            (host seconds);
            The LJ phase's graphs: community_rmat(512, 22, 8, seed=1) with
            unit weights (scripts/lj_step_probe.py:57-71; 4,194,304
            vertices) planned four ways (f32, x_precision='bf16', the
            tiering of scripts/scattered_sweep.py:43, the same under
            nohubs), and rmat(20, 8, seed=1) in partition order with its
            own hierarchy, planned at f32 and bf16;
  kernels   every kernel against its plain PyTorch version on the card, at
            the shapes its path gives it: kernel A (unit, weighted, bf16x)
            and kernel B on the level-0 slot layout of mesh3d(128) and its
            first Galerkin level; kernel A (unit, bf16x, stream-only) on the
            community graph's residual CSR, exact on its weighted tiered
            CSR; kernel D on both flat graphs and the community graph (with
            kernel A's residual y_res where there is one); kernels E and C
            on the rmat graph under linlog.  Every
            output element within RTOL of its own sum of |terms| (kernel D:
            f so, x' against the plain update applied to the kernel's own
            f); median times from CUDA events;
  entry     ``spmv_windowed`` under each of the reference's variant names
            and ``spmv_windowed_v5``, once each on the slot CSRs, each
            output held to the plain version of the mode it routes to;
  reference the port on the card against its plain versions on the CPU
            from one warm start: the embed on a small graph, and five flat
            tiled steps (fused, linlog, a tiered plan, x_precision='bf16')
            on injected sample ids;
  main      embed_graph on mesh3d(128) (2.1M vertices, 12.5M stored
            entries), dim 3, coarsening factor 0.1, the embed driver's default
            iteration counts; phase seconds, launch counts of kernels A and
            B (each must be > 0), finite [n, 3] output with every vertex
            inside its parent ball;
  flat      the tiled step at the bench's widths (dim 3, 64 samples) on
            both flat graphs: median of 5 CUDA-event timings of 20
            iterations after warm-up, stored entries per second per
            iteration (bench.py:119), launches of kernel D (and A on rmat);
  linlog    the same step with linlog on the rmat graph (kernels E and C);
  lj        the flat step on the LJ phase's six plans: host seconds of
            prepare_tiled, ms per iteration and stored entries per second
            as in the flat phase, launches (bf16x and exact must run);
  bf16 embed  embed_graph on mesh3d(128) with x_precision='bf16' in both
            params: phase seconds beside the f32 embed's, bf16x launches in
            the level-0 refine;
  determinism  two embed_graph runs on mesh3d(12) (random init, then a warm
            start), two runs of the mesh3d(128) flat step and two of the
            community graph's bf16 step: torch.equal;
  cli       ``python -m graph_embed_tpu_torch.cli embed`` on a small
            ring-of-cliques file.
Each path (main, entry, flat per graph, linlog, lj per plan, bf16 embed)
is driven with the launch counts set to 0 just before it and read just
after.
Then the nvidia-smi line, the kernel summary as one JSON object, and the
result line.  Any failed check exits non-zero with no result.  There is
no CPU run: without a CUDA device the script exits 1 at once.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# mesh3d(128): 2,097,152 vertices, 12,484,608 stored entries
MESH_SIDE = 128
# kernel vs plain, per element, relative to the element's sum of |terms|
RTOL = 1e-5
# the flat step: bench.py's samples, iterations per timing and timings
FLAT_SAMPLES = 64
FLAT_ITERS = 20
FLAT_REPEATS = 5
LINLOG_ITERS = 5
# the LJ phase (scripts/lj_step_probe.py, scripts/scattered_sweep.py:43)
LJ_GRAPH = (512, 22, 8)
LJ_TIERS = dict(tiered_specs=((1024, 2048, 1024), (8192, 8192, 1024)),
                tiered_thresholds=(256,))
# the reference phase's small tiering: a bf16 tier and a wide one
SMALL_TIERS = dict(tiered_specs=((256, 256, 128), (1024, 1024, 128)),
                   tiered_thresholds=(32,))


def emit(**record) -> None:
    print(json.dumps(record), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: check failed: {what}")


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def max_err(got, want) -> tuple[float, float]:
    """(max abs error, max abs error / max |want|)."""
    err = float((got - want).abs().max()) if want.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    return err, err / scale if scale > 0 else err


def scaled_err(got, want, scale) -> tuple[float, float]:
    """(max |got - want|, max |got - want| / scale), element by element.

    ``scale`` holds each element's sum of |terms|: float32 summation in
    another order moves an element by a small multiple of 2^-24 of it, while
    a wrong term moves it by a sizeable fraction.  An element that differs
    where its scale is 0 gives an infinite ratio."""
    import torch

    if not want.numel():
        return 0.0, 0.0
    err = (got - want).abs()
    ratio = torch.where(err == 0, torch.zeros_like(err), err / scale)
    return float(err.max()), float(ratio.max())


def phase_env(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=120, check=True).stdout.strip().splitlines()[0]
    require(torch.backends.cuda.matmul.allow_tf32 is False,
            "TF32 matmuls are off")
    emit(phase="env", nvidia_smi=smi, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])
    return smi


def phase_build() -> None:
    from graph_embed_tpu_torch.ops import cuda

    t0 = time.perf_counter()
    report = cuda.build()
    cuda.library()
    usage = [ln.strip() for ln in report.splitlines()
             if "registers" in ln or "spill" in ln]
    emit(phase="build", seconds=time.perf_counter() - t0, ptxas=usage)


def phase_kernels(torch, g, res, dev) -> dict:
    """Kernels against their plain versions at main-path shapes.  Every
    element must lie within RTOL of its own scale (``scaled_err``)."""
    import dataclasses

    from graph_embed_tpu_torch.forceatlas import multilevel_tiled as MT
    from graph_embed_tpu_torch.ops import edge_spmm as ES
    from graph_embed_tpu_torch.utils.params import MultilevelFAParams

    params = MultilevelFAParams()
    gen = torch.Generator(device=dev).manual_seed(1)
    out = {}
    slots = {}
    b_err = []
    b_ms = b_plain_ms = 0.0
    for level, graph in ((0, g), (1, res.coarse_graphs[0])):
        layout = MT.prepare_refine(graph.to(dev), res.levels[level].to(dev),
                                   params)
        x = torch.rand((layout.n_slots, 3), generator=gen, device=dev) * 2 - 1
        x = torch.where(layout.valid_slot[:, None], x, torch.zeros_like(x))
        csr = layout.csr
        name = "edge_spmm[unit]" if csr.w is None else "edge_spmm[weighted]"
        got = ES.spmv_cuda(x, csr)
        want = ES.spmv_plain(x, csr)
        scale = ES.spmv_plain(x.abs(), csr if csr.w is None else
                              dataclasses.replace(csr, w=csr.w.abs()))
        torch.cuda.synchronize()
        err, ratio = scaled_err(got, want, scale)
        ms = cuda_ms(lambda: ES.spmv_cuda(x, csr))
        plain_ms = cuda_ms(lambda: ES.spmv_plain(x, csr))
        emit(phase="kernels", kernel=name, level=level, rows=csr.n_rows,
             nnz=csr.nnz, max_abs_err=err, max_err_over_scale=ratio,
             rtol=RTOL, ms=ms, plain_ms=plain_ms)
        require(ratio <= RTOL, f"{name} agrees with its plain version")
        out[name] = dict(max_abs_err=err, max_err_over_scale=ratio, ms=ms,
                         plain_ms=plain_ms)
        slots[level] = (csr, x)
        if csr.w is None:
            out["edge_spmm[bf16x] slots"] = check_bf16x(
                torch, csr, x, level=level)

        got = MT.exact_repulsion_cuda(x, layout, params.repel,
                                      params.epsilon)
        want = MT.exact_repulsion_plain(x, layout, params.repel,
                                        params.epsilon)
        scale = MT.exact_repulsion_plain(x, layout, params.repel,
                                         params.epsilon, absolute=True)
        torch.cuda.synchronize()
        for b in layout.buckets:
            if b.sampled:
                continue
            sl = b.slots
            err, ratio = scaled_err(got[sl], want[sl], scale[sl])
            members = want[sl][layout.valid_slot[sl]]
            emit(phase="kernels", kernel="bucket_repulsion", level=level,
                 S=b.S, aggregates=b.m_b, max_abs_err=err,
                 max_err_over_scale=ratio, rtol=RTOL,
                 median_abs_member_force=float(members.abs().median()))
            require(ratio <= RTOL, f"bucket_repulsion S={b.S} agrees with "
                    "its plain version")
            b_err.append((err, ratio))
        ms = cuda_ms(lambda: MT.exact_repulsion_cuda(
            x, layout, params.repel, params.epsilon))
        plain_ms = cuda_ms(lambda: MT.exact_repulsion_plain(
            x, layout, params.repel, params.epsilon), reps=5, warmup=1)
        emit(phase="kernels", kernel="bucket_repulsion", level=level,
             slots=layout.n_slots, ctas=int(layout.exact_meta.shape[0]),
             ms=ms, plain_ms=plain_ms)
        if level == 0:
            b_ms, b_plain_ms = ms, plain_ms
    out["bucket_repulsion"] = dict(
        max_abs_err=max(e for e, _ in b_err),
        max_err_over_scale=max(r for _, r in b_err), ms=b_ms,
        plain_ms=b_plain_ms)
    return out, slots


def check_bf16x(torch, csr, x, **fields) -> dict:
    """Kernel A's bf16x mode against its plain version on one unit CSR;
    times both, beside the unit mode on the same CSR and x."""
    from graph_embed_tpu_torch.ops import edge_spmm as ES

    xp = ES.pack_x_bf16(x)
    d = x.shape[1]
    got = ES.spmv_bf16x_cuda(xp, csr, d)
    want = ES.spmv_bf16x_plain(xp, csr, d)
    scale = ES.spmv_plain(ES.unpack_x_bf16(xp, d).abs(), csr)
    torch.cuda.synchronize()
    err, ratio = hold("edge_spmm[bf16x]", got, want, scale, rows=csr.n_rows,
                      nnz=csr.nnz, **fields)
    res = dict(max_abs_err=err, max_err_over_scale=ratio,
               ms=cuda_ms(lambda: ES.spmv_bf16x_cuda(xp, csr, d)),
               plain_ms=cuda_ms(lambda: ES.spmv_bf16x_plain(xp, csr, d),
                                reps=5, warmup=1),
               unit_ms=cuda_ms(lambda: ES.spmv_cuda(x, csr)),
               pack_ms=cuda_ms(lambda: ES.pack_x_bf16(x)))
    emit(phase="kernels", kernel="edge_spmm[bf16x]", **fields,
         **{k: res[k] for k in ("ms", "plain_ms", "unit_ms", "pack_ms")})
    return res


def phase_lj_kernels(torch, lj: dict, dev) -> dict:
    """Kernel A's bf16x and stream-only modes (beside its unit mode) on the
    community graph's residual CSR, and its exact route on the weighted
    tiered CSR, against their plain versions."""
    import dataclasses

    from graph_embed_tpu_torch.ops import edge_spmm as ES

    gen = torch.Generator(device=dev).manual_seed(3)
    g, tfa, _, _ = lj["community bf16"]
    csr = tfa.csr
    require(csr is not None and csr.kind == "unit" and csr.bf16_gather,
            "the community graph's bf16 plan has a paired unit residual")
    x = torch.rand((g.n, 3), generator=gen, device=dev) * 2 - 1
    out = {"edge_spmm[bf16x]": check_bf16x(torch, csr, x,
                                           graph="community_rmat")}
    got = ES.spmv_null_cuda(x, csr)
    torch.cuda.synchronize()
    require(not bool(got.any()), "the stream-only mode writes zeros")
    out["edge_spmm[vnull]"] = dict(
        max_abs_err=0.0, max_err_over_scale=0.0,
        ms=cuda_ms(lambda: ES.spmv_null_cuda(x, csr)),
        plain_ms=cuda_ms(lambda: ES.spmv_null_plain(x, csr)))
    emit(phase="kernels", kernel="edge_spmm[vnull]", graph="community_rmat",
         rows=csr.n_rows, nnz=csr.nnz, ms=out["edge_spmm[vnull]"]["ms"],
         unit_ms=out["edge_spmm[bf16x]"]["unit_ms"],
         bf16x_ms=out["edge_spmm[bf16x]"]["ms"])

    g, tfa, _, _ = lj["community tiered nohubs"]
    csr = tfa.csr
    require(csr.kind == "exact", "every nohubs tier is wide (exact)")
    got = ES.spmv_cuda(x, csr)
    want = ES.spmv_plain(x, csr)
    scale = ES.spmv_plain(x.abs(), dataclasses.replace(csr, w=csr.w.abs()))
    torch.cuda.synchronize()
    err, ratio = hold("edge_spmm[exact]", got, want, scale,
                      graph="community_rmat tiered nohubs", rows=csr.n_rows,
                      nnz=csr.nnz)
    out["edge_spmm[exact]"] = dict(
        max_abs_err=err, max_err_over_scale=ratio,
        ms=cuda_ms(lambda: ES.spmv_cuda(x, csr)),
        plain_ms=cuda_ms(lambda: ES.spmv_plain(x, csr), reps=5, warmup=1))
    emit(phase="kernels", kernel="edge_spmm[exact]",
         graph="community_rmat tiered nohubs",
         ms=out["edge_spmm[exact]"]["ms"],
         plain_ms=out["edge_spmm[exact]"]["plain_ms"])
    return out


def phase_entry(torch, slots: dict) -> dict:
    """The explicit entry points: ``spmv_windowed`` under every variant
    name the reference accepts (unit names on the level-0 slot CSR, the
    bf16-word names on the first Galerkin level's) and
    ``spmv_windowed_v5``, once each with the counts set to 0 before; then
    each output against the plain version of the mode it routes to."""
    import dataclasses

    from graph_embed_tpu_torch.ops import cuda
    from graph_embed_tpu_torch.ops import edge_spmm as ES

    (csr0, x0), (csr1, x1) = slots[0], slots[1]
    require(csr0.kind == "unit" and csr1.kind == "weighted",
            "level 0 has unit weights, level 1 truncated ones")
    calls = [(v, csr0, x0) for v in ES.UNIT_VARIANTS]
    calls += [(v, csr1, x1) for v in ES.WEIGHTED_VARIANTS]
    cuda.LAUNCHES.clear()
    outs = [ES.spmv_windowed(x, csr, variant=v) for v, csr, x in calls]
    outs.append(ES.spmv_windowed_v5(x1, csr1))
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    calls.append(("v5", csr1, x1))
    worst = 0.0
    for (v, csr, x), got in zip(calls, outs):
        if v == "vnull":
            require(not bool(got.any()), "vnull writes zeros")
            continue
        if v.startswith("v12b"):
            x = ES.unpack_x_bf16(ES.pack_x_bf16(x), x.shape[1])
        wabs = csr if csr.w is None else dataclasses.replace(
            csr, w=csr.w.abs())
        err, ratio = scaled_err(got, ES.spmv_plain(x, csr),
                                ES.spmv_plain(x.abs(), wabs))
        require(ratio <= RTOL, f"spmv_windowed variant {v} agrees with "
                "its plain version")
        worst = max(worst, ratio)
    for name in ("edge_spmm[unit]", "edge_spmm[weighted]",
                 "edge_spmm[bf16x]", "edge_spmm[vnull]"):
        require(launches.get(name, 0) > 0, f"{name} launched on the "
                "variant entry path")
    emit(phase="entry", variants=[v for v, _, _ in calls],
         max_err_over_scale=worst, rtol=RTOL, launches=launches)
    return launches


def flat_params(linlog: bool = False, **kw):
    from graph_embed_tpu_torch.utils.params import ForceAtlasParams

    return ForceAtlasParams(repulsion="sampled",
                            num_negative_samples=FLAT_SAMPLES, linlog=linlog,
                            **kw)


def setup_flat(dev, mesh) -> dict:
    """The flat step's graphs on the card, each with its tiled plan:
    {name: (graph, TiledFA, prepare seconds)}, plus 'rmat_linlog'."""
    import numpy as np
    import torch

    import graph_embed_tpu_torch as gp
    from graph_embed_tpu_torch.forceatlas import tiled as TL
    from graph_embed_tpu_torch.graph import synth

    t0 = time.perf_counter()
    rmat = synth.rmat(20, 8, seed=1)
    s, r, _ = rmat.to_coo_numpy()
    # simple-graph weights (bench.py:68-70): the COO is canonical already
    rmat = gp.from_canonical_coo(s, r, np.ones(s.size), rmat.n)
    emit(phase="setup", graph="rmat(20, 8, seed=1)", n=rmat.n,
         stored_entries=rmat.num_edges, seconds=time.perf_counter() - t0)
    flat = {}
    for name, g, linlog in ((f"mesh3d({MESH_SIDE})", mesh, False),
                            ("rmat(20,8)", rmat, False),
                            ("rmat(20,8) linlog", rmat, True)):
        g = g.to(dev)
        t0 = time.perf_counter()
        tfa = TL.prepare_tiled(g, 3, flat_params(linlog))
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        flat[name] = (g, tfa, sec)
        emit(phase="setup", graph=name, prepare_tiled_seconds=sec,
             dia_offsets=list(tfa.dia_offsets),
             residual_entries=0 if tfa.csr is None else tfa.csr.nnz,
             unit_residual=tfa.csr is not None and tfa.csr.w is None)
    return flat


def setup_lj(dev) -> dict:
    """The LJ phase's plans on the card: {name: (graph, TiledFA, params,
    prepare seconds)}.  The community graph is built once and planned four
    ways; rmat(20, 8) is put in partition order with its own hierarchy."""
    import numpy as np
    import torch

    import graph_embed_tpu_torch as gp
    from graph_embed_tpu_torch.forceatlas import tiled as TL

    t0 = time.perf_counter()
    cg = gp.community_rmat(*LJ_GRAPH, seed=1)
    s, r, _ = cg.to_coo_numpy()
    # unit weights, as scripts/lj_step_probe.py:68-70 sets them
    cg = gp.from_canonical_coo(s, r, np.ones(s.size), cg.n)
    emit(phase="setup", graph="community_rmat(%d, %d, %d, seed=1)" % LJ_GRAPH,
         n=cg.n, stored_entries=cg.num_edges,
         seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    rg = gp.synth.rmat(20, 8, seed=1)
    s, r, _ = rg.to_coo_numpy()
    rg = gp.from_canonical_coo(s, r, np.ones(s.size), rg.n)
    levels = gp.partition_hierarchy(rg, 0.1).levels
    og, _ = gp.apply_order(rg, gp.partition_order(rg, levels=levels))
    emit(phase="setup", graph="rmat(20, 8, seed=1) partition-ordered",
         n=og.n, stored_entries=og.num_edges, levels=len(levels),
         seconds=time.perf_counter() - t0)
    cg, og = cg.to(dev), og.to(dev)
    plans = (("community f32", cg, flat_params(), {}),
             ("community bf16", cg, flat_params(x_precision="bf16"), {}),
             ("community tiered", cg, flat_params(), LJ_TIERS),
             ("community tiered nohubs", cg, flat_params(nohubs=True),
              LJ_TIERS),
             ("rmat(20,8) ordered f32", og, flat_params(), {}),
             ("rmat(20,8) ordered bf16", og, flat_params(x_precision="bf16"),
              {}))
    lj = {}
    for name, g, params, kw in plans:
        t0 = time.perf_counter()
        tfa = TL.prepare_tiled(g, 3, params, **kw)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        lj[name] = (g, tfa, params, sec)
        csr = tfa.csr
        emit(phase="setup", graph=name, prepare_tiled_seconds=sec,
             dia_offsets=list(tfa.dia_offsets),
             residual_entries=0 if csr is None else csr.nnz,
             residual_kind=None if csr is None else csr.kind,
             bf16_gather=csr is not None and csr.bf16_gather)
    return lj


def lj_needs(tfa, params) -> tuple:
    """The kernels the LJ step on this plan must launch: kernel D, and
    kernel A in the mode its residual takes."""
    csr = tfa.csr
    if csr is None:
        return ("fused_step",)
    mode = ("bf16x" if params.x_precision == "bf16" and csr.bf16_gather
            else csr.kind)
    return ("fused_step", f"edge_spmm[{mode}]")


def phase_lj(torch, lj: dict, dev) -> dict:
    """The flat step on each LJ plan; launches per plan."""
    from graph_embed_tpu_torch.ops import cuda

    launches = {}
    for name, (g, tfa, params, prep) in lj.items():
        drive_steps(torch, tfa, params, dev, 2)   # warm-up
        torch.cuda.synchronize()
        cuda.LAUNCHES.clear()
        times = []
        for rep in range(FLAT_REPEATS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            x = drive_steps(torch, tfa, params, dev, FLAT_ITERS, seed=rep)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / FLAT_ITERS)
        path = dict(cuda.LAUNCHES)
        launches[name] = path
        require(tuple(x.shape) == (g.n, 3) and bool(torch.isfinite(x).all()),
                f"{name}: finite [n, 3] coordinates")
        for k in lj_needs(tfa, params):
            require(path.get(k, 0) > 0, f"{k} launched on the {name} path")
        ms = statistics.median(times)
        emit(phase="lj", graph=name, n=g.n, stored_entries=g.num_edges,
             prepare_tiled_seconds=prep, iterations=FLAT_ITERS,
             repeats=FLAT_REPEATS, ms_per_iteration=ms,
             ms_per_iteration_all=times,
             entries_per_second=g.num_edges / (ms / 1e3), launches=path)
    require(launches["community bf16"].get("edge_spmm[bf16x]", 0) > 0,
            "the bf16 plan gathers bf16 pairs")
    require(launches["community tiered nohubs"].get("edge_spmm[exact]", 0)
            > 0, "the nohubs tiering runs the exact route")
    return launches


def phase_bf16_embed(torch, g, dev, f32_wall: float) -> dict:
    """embed_graph with x_precision='bf16' in both params; its phase
    seconds beside the f32 embed's; bf16x launches in the level-0
    refine."""
    import graph_embed_tpu_torch as gp
    from graph_embed_tpu_torch.ops import cuda

    after_level = {}

    def count(level, coords, *_):
        after_level[level] = cuda.LAUNCHES["edge_spmm[bf16x]"]
        require(bool(torch.isfinite(coords).all()), f"level {level} finite")

    metrics = gp.MetricsLogger()
    cuda.LAUNCHES.clear()
    t0 = time.perf_counter()
    coords, res = gp.embed_graph(
        g, 3, device=dev, coarsening_factor=0.1, metrics=metrics,
        base_params=gp.ForceAtlasParams(x_precision="bf16"),
        refine_params=gp.MultilevelFAParams(x_precision="bf16"),
        on_level=count)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda.LAUNCHES)
    level0 = after_level[0] - after_level.get(1, 0)
    require(tuple(coords.shape) == (g.n, 3)
            and bool(torch.isfinite(coords).all()), "finite [n, 3] output")
    require(level0 > 0, "the level-0 refine gathers bf16 pairs")
    emit(phase="bf16 embed", n=g.n, seconds=wall, f32_seconds=f32_wall,
         level0_bf16x_launches=level0, launches=launches,
         spans=metrics.records)
    return launches


def hold(kernel: str, got, want, scale, **fields) -> tuple[float, float]:
    """Emit and require the per-element check of one kernel output."""
    err, ratio = scaled_err(got, want, scale)
    emit(phase="kernels", kernel=kernel, max_abs_err=err,
         max_err_over_scale=ratio, rtol=RTOL, **fields)
    require(ratio <= RTOL, f"{kernel} agrees with its plain version "
            f"({fields})")
    return err, ratio


def phase_flat_kernels(torch, flat: dict, lj: dict, dev) -> dict:
    """Kernels D, E and C against their plain versions at the flat step's
    full-width shapes (kernel D also on the community graph's f32 plan)."""
    from graph_embed_tpu_torch.ops import edge_spmm as ES
    from graph_embed_tpu_torch.ops import fused_step as FS
    from graph_embed_tpu_torch.ops import repulsion as RP

    gen = torch.Generator(device=dev).manual_seed(2)
    out = {}
    d_err = []
    plans = [(name, *flat[name][:2]) for name in (f"mesh3d({MESH_SIDE})",
                                                  "rmat(20,8)")]
    plans.append(("community_rmat", *lj["community f32"][:2]))
    for name, g, tfa in plans:
        params = flat_params()
        x = torch.rand((g.n, 3), generator=gen, device=dev) * 2 - 1
        fprev = torch.rand((g.n, 3), generator=gen, device=dev) * 2 - 1
        idx = RP.draw_samples(g.n, FLAT_SAMPLES, gen, dev)
        y_res = None
        if tfa.csr is not None:
            # kernel A on the residual edges, hub rows included
            y_res = ES.spmv_cuda(x, tfa.csr)
            want = ES.spmv_plain(x, tfa.csr)
            scale = ES.spmv_plain(x.abs(), tfa.csr)   # unit weights
            torch.cuda.synchronize()
            err, ratio = hold("edge_spmm[unit]", y_res, want, scale,
                              graph=name, rows=tfa.csr.n_rows,
                              nnz=tfa.csr.nnz)
            emit(phase="kernels", kernel="edge_spmm[unit]", graph=name,
                 ms=cuda_ms(lambda: ES.spmv_cuda(x, tfa.csr)),
                 plain_ms=cuda_ms(lambda: ES.spmv_plain(x, tfa.csr),
                                  reps=5, warmup=1))
            prev = out.get("edge_spmm[unit] flat", dict(
                max_abs_err=0.0, max_err_over_scale=0.0))
            out["edge_spmm[unit] flat"] = dict(
                max_abs_err=max(err, prev["max_abs_err"]),
                max_err_over_scale=max(ratio, prev["max_err_over_scale"]))
        dia = (tfa.dia_w, tfa.dia_offsets, tfa.dia_off)
        rest = (tfa.deg_w_att, tfa.deg_p1, idx, params)
        got_x, got_f = FS.fa_step_fused_cuda(x, fprev, dia[0], dia[2], y_res,
                                             *rest)
        plain = (x, dia[0], dia[1], y_res, *rest)
        want_f = FS.step_forces_plain(*plain)
        scale_f = FS.step_forces_plain(*plain, absolute=True)
        want_x = FS.speed_update(x, got_f, fprev, params)
        torch.cuda.synchronize()
        err, ratio = hold("fused_step", got_f, want_f, scale_f, graph=name,
                          output="f")
        _, ratio_x = hold("fused_step", got_x, want_x,
                          x.abs() + (want_x - x).abs(), graph=name,
                          output="x'")
        d_err.append((err, max(ratio, ratio_x)))
        ms = cuda_ms(lambda: FS.fa_step_fused_cuda(x, fprev, dia[0], dia[2],
                                                   y_res, *rest))
        plain_ms = cuda_ms(lambda: FS.fa_step_fused_plain(
            x, fprev, dia[0], dia[1], y_res, *rest), reps=5, warmup=1)
        emit(phase="kernels", kernel="fused_step", graph=name, n=g.n,
             dia_offsets=len(tfa.dia_offsets), y_res=y_res is not None,
             ms=ms, plain_ms=plain_ms)
        if "fused_step" not in out:
            out["fused_step"] = dict(ms=ms, plain_ms=plain_ms)
    out["fused_step"].update(max_abs_err=max(e for e, _ in d_err),
                             max_err_over_scale=max(r for _, r in d_err))

    g, tfa, _ = flat["rmat(20,8) linlog"]
    params = flat_params(linlog=True)
    x = torch.rand((g.n, 3), generator=gen, device=dev) * 2 - 1
    kw = dict(attract=params.attract, eps=params.epsilon)
    got = ES.linlog_cuda(x, tfa.csr, **kw)
    want = ES.linlog_plain(x, tfa.csr, **kw)
    scale = ES.linlog_plain(x, tfa.csr, absolute=True, **kw)
    torch.cuda.synchronize()
    err, ratio = hold("edge_linlog", got, want, scale, graph="rmat(20,8)",
                      rows=tfa.csr.n_rows, nnz=tfa.csr.nnz)
    out["edge_linlog"] = dict(
        max_abs_err=err, max_err_over_scale=ratio, ms=cuda_ms(lambda: ES.linlog_cuda(x, tfa.csr, **kw)),
        plain_ms=cuda_ms(lambda: ES.linlog_plain(x, tfa.csr, **kw), reps=5,
                         warmup=1))

    idx = RP.draw_samples(g.n, FLAT_SAMPLES, gen, dev)
    kw = dict(repel=params.repel, eps=params.epsilon)
    got = RP.repulsion_sampled_cuda(x, tfa.deg_p1, idx, **kw)
    want = RP.repulsion_sampled_plain(x, tfa.deg_p1, idx, **kw)
    scale = RP.repulsion_sampled_plain(x, tfa.deg_p1, idx, absolute=True,
                                       **kw)
    torch.cuda.synchronize()
    err, ratio = hold("sampled_repulsion", got, want, scale,
                      graph="rmat(20,8)", n=g.n, samples=FLAT_SAMPLES)
    out["sampled_repulsion"] = dict(
        max_abs_err=err, max_err_over_scale=ratio,
        ms=cuda_ms(lambda: RP.repulsion_sampled_cuda(x, tfa.deg_p1, idx,
                                                     **kw)),
        plain_ms=cuda_ms(lambda: RP.repulsion_sampled_plain(
            x, tfa.deg_p1, idx, **kw), reps=5, warmup=1))
    for name in ("edge_linlog", "sampled_repulsion"):
        emit(phase="kernels", kernel=name, graph="rmat(20,8)",
             ms=out[name]["ms"], plain_ms=out[name]["plain_ms"])
    return out


def phase_reference(torch, dev) -> None:
    """The whole slice on the card (kernels) against the CPU (plain
    versions): one small hierarchy, one warm start, no random init."""
    import numpy as np

    import graph_embed_tpu_torch as gp
    from graph_embed_tpu_torch.graph import synth

    g = synth.mesh3d(12)
    res = gp.partition_hierarchy(g, 0.1, emit_graphs=True)
    coords0 = torch.from_numpy(
        np.random.default_rng(5).uniform(-1, 1, (g.n, 3)).astype(np.float32))
    kw = dict(base_iterations=100, refine_iterations=5, coords0=coords0)
    graphs = [g] + res.coarse_graphs
    cpu = gp.embed(graphs, res.levels, 3, device="cpu", **kw)
    card = gp.embed(graphs, res.levels, 3, device=dev, **kw).cpu()
    err, rel = max_err(card, cpu)
    emit(phase="reference", n=g.n, levels=res.level_sizes, max_abs_err=err,
         max_rel_err=rel, tol_rel=2e-3)
    require(rel <= 2e-3, "the card's embed agrees with the CPU's")

    # the flat tiled step: five steps, the same sample ids on both sides
    # (the CPU's and the card's generators differ)
    from graph_embed_tpu_torch.forceatlas import tiled as TL

    g = synth.mesh3d(7, extra_frac=0.3, seed=2)   # DIA plus residual edges
    rng = np.random.default_rng(6)
    x0 = torch.from_numpy(rng.uniform(-1, 1, (g.n, 3)).astype(np.float32))
    ids = [torch.from_numpy(rng.integers(0, g.n, FLAT_SAMPLES).astype(
        np.int32)) for _ in range(5)]
    for linlog in (False, True):
        params = flat_params(linlog)
        runs = [TL.tiled_loop(x0.to(d), TL.prepare_tiled(
                    g.to(d), 3, params, dia_min_count=32), params, 5,
                    sample_ids=[i.to(d) for i in ids]).cpu()
                for d in ("cpu", dev)]
        err, rel = max_err(runs[1], runs[0])
        emit(phase="reference", path="flat tiled step", linlog=linlog,
             n=g.n, steps=5, max_abs_err=err, max_rel_err=rel, tol_rel=2e-3)
        require(rel <= 2e-3, f"the card's flat step (linlog={linlog}) "
                "agrees with the CPU's")

    # a tiered plan (a bf16 tier and a wide one, nohubs weights) and an
    # x_precision='bf16' plan on a small community graph
    cg = gp.community_rmat(8, 12, 8, seed=2)
    s, r, _ = cg.to_coo_numpy()
    cg = gp.from_canonical_coo(s, r, np.ones(s.size), cg.n)
    x0 = torch.from_numpy(rng.uniform(-1, 1, (cg.n, 3)).astype(np.float32))
    ids = [torch.from_numpy(rng.integers(0, cg.n, FLAT_SAMPLES).astype(
        np.int32)) for _ in range(5)]
    for path, params, kw in (
            ("tiered", flat_params(nohubs=True), SMALL_TIERS),
            ("bf16", flat_params(x_precision="bf16"),
             dict(spmv_mode="packed"))):
        runs = []
        for d in ("cpu", dev):
            tfa = TL.prepare_tiled(cg.to(d), 3, params, **kw)
            runs.append(TL.tiled_loop(x0.to(d), tfa, params, 5,
                                      sample_ids=[i.to(d) for i in ids]
                                      ).cpu())
        require(path != "bf16" or tfa.csr.bf16_gather,
                "the small bf16 plan gathers bf16 pairs")
        err, rel = max_err(runs[1], runs[0])
        emit(phase="reference", path=f"flat tiled step, {path}", n=cg.n,
             steps=5, residual_kind=tfa.csr.kind, max_abs_err=err,
             max_rel_err=rel, tol_rel=2e-3)
        require(rel <= 2e-3, f"the card's {path} flat step agrees with the "
                "CPU's")


def phase_main(torch, g, dev, coarsening: float) -> dict:
    import graph_embed_tpu_torch as gp
    from graph_embed_tpu_torch.ops import cuda

    excess = {}

    def check_level(level, coords, part, centres, radii):
        v2a = part.vertex_to_agg
        dist = torch.linalg.norm(coords - centres[v2a], dim=1)
        slack = 1e-5 * float(centres.abs().max()) + 1e-6
        excess[level] = float((dist - radii[v2a]).max())
        require(excess[level] <= slack, f"level {level} packs into its "
                f"parent balls (excess {excess[level]} > {slack})")
        require(bool(torch.isfinite(coords).all()), f"level {level} finite")

    metrics = gp.MetricsLogger()
    cuda.LAUNCHES.clear()
    t0 = time.perf_counter()
    coords, res = gp.embed_graph(g, 3, device=dev,
                                 coarsening_factor=coarsening,
                                 metrics=metrics, on_level=check_level)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda.LAUNCHES)
    require(tuple(coords.shape) == (g.n, 3), "output shape [n, 3]")
    require(bool(torch.isfinite(coords).all()), "finite coordinates")
    require(sorted(excess) == list(range(len(res.levels))),
            "every level was checked against its parent balls")
    for name in ("edge_spmm[unit]", "edge_spmm[weighted]",
                 "bucket_repulsion"):
        require(launches.get(name, 0) > 0, f"{name} launched on the main "
                "path")
    emit(phase="main", n=g.n, stored_entries=g.num_edges,
         level_sizes=res.level_sizes, seconds=wall, launches=launches,
         ball_excess=excess, spans=metrics.records)
    return launches, wall


def drive_steps(torch, tfa, params, dev, iters: int, seed: int = 0):
    """``iters`` steps of the tiled step from a seeded start; returns the
    final coordinates."""
    from graph_embed_tpu_torch.forceatlas import tiled as TL

    gen = torch.Generator(device=dev).manual_seed(seed)
    x0 = torch.rand((tfa.n, 3), generator=gen, device=dev) * 2 - 1
    return TL.tiled_loop(x0, tfa, params, iters, generator=gen)


def phase_flat(torch, flat: dict, dev) -> dict:
    """The tiled step at the bench's widths; launches per path."""
    from graph_embed_tpu_torch.ops import cuda

    launches = {}
    for name, needs in ((f"mesh3d({MESH_SIDE})", ("fused_step",)),
                        ("rmat(20,8)", ("edge_spmm[unit]", "fused_step")),
                        ("rmat(20,8) linlog", ("edge_linlog",
                                               "sampled_repulsion"))):
        g, tfa, prep = flat[name]
        params = flat_params(linlog="linlog" in name)
        iters = LINLOG_ITERS if params.linlog else FLAT_ITERS
        repeats = 1 if params.linlog else FLAT_REPEATS
        drive_steps(torch, tfa, params, dev, 2)   # warm-up
        torch.cuda.synchronize()
        cuda.LAUNCHES.clear()
        times = []
        for rep in range(repeats):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            x = drive_steps(torch, tfa, params, dev, iters, seed=rep)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / iters)
        path = dict(cuda.LAUNCHES)
        launches[name] = path
        require(tuple(x.shape) == (g.n, 3) and bool(torch.isfinite(x).all()),
                f"{name}: finite [n, 3] coordinates")
        for k in needs:
            require(path.get(k, 0) > 0, f"{k} launched on the {name} path")
        ms = statistics.median(times)
        emit(phase="linlog" if params.linlog else "flat", graph=name, n=g.n,
             stored_entries=g.num_edges, prepare_tiled_seconds=prep,
             iterations=iters, repeats=repeats, ms_per_iteration=ms,
             ms_per_iteration_all=times,
             entries_per_second=g.num_edges / (ms / 1e3), launches=path)
    return launches


def phase_determinism(torch, flat: dict, lj: dict, dev) -> None:
    """Two runs from one seed give equal tensors."""
    import numpy as np

    import graph_embed_tpu_torch as gp
    from graph_embed_tpu_torch.graph import synth

    g = synth.mesh3d(12)
    warm = torch.from_numpy(
        np.random.default_rng(8).uniform(-1, 1, (g.n, 3)).astype(np.float32))
    for kw in ({}, {"coords0": warm}):
        runs = [gp.embed_graph(g, 3, device=dev, base_iterations=2000,
                               seed=7, **kw)[0] for _ in range(2)]
        require(torch.equal(runs[0], runs[1]), "two embeds on the card are "
                f"equal (warm start: {bool(kw)})")
    _, tfa, _ = flat[f"mesh3d({MESH_SIDE})"]
    runs = [drive_steps(torch, tfa, flat_params(), dev, 5, seed=9)
            for _ in range(2)]
    require(torch.equal(runs[0], runs[1]),
            "two runs of the mesh flat step are equal")
    _, tfa, params, _ = lj["community bf16"]
    runs = [drive_steps(torch, tfa, params, dev, 5, seed=9)
            for _ in range(2)]
    require(torch.equal(runs[0], runs[1]),
            "two runs of the community graph's bf16 step are equal")
    emit(phase="determinism", embed="mesh3d(12) x2, cold and warm",
         flat=f"mesh3d({MESH_SIDE}) 5 steps x2",
         bf16_flat="community_rmat bf16 5 steps x2", equal=True)


def phase_cli(dev) -> None:
    import numpy as np

    work = os.path.join(ROOT, "graph_embed_tpu_torch", "_build", "smoke")
    os.makedirs(work, exist_ok=True)
    K, C = 8, 16
    i, j = np.triu_indices(K, 1)
    lines = []
    for c in range(C):
        lines += [f"{c * K + a} {c * K + b}" for a, b in zip(i, j)]
        lines.append(f"{c * K} {((c + 1) % C) * K}")
    src = os.path.join(work, "ring.txt")
    dst = os.path.join(work, "ring_coords.txt")
    with open(src, "w") as f:
        f.write("\n".join(lines) + "\n")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "graph_embed_tpu_torch.cli", "embed", "-f",
         src, "-format", "adjlist", "-symmetric", "true", "-dimension", "3",
         "-o", dst, "-device", str(dev)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    require(proc.returncode == 0, "cli embed exits 0: " + proc.stderr[-2000:])
    rows = np.array([[float(v) for v in ln.split()]
                     for ln in open(dst).read().splitlines()])
    require(rows.shape == (K * C, 3) and bool(np.isfinite(rows).all()),
            "cli writes one finite row per vertex")
    emit(phase="cli", vertices=K * C, rows=int(rows.shape[0]),
         seconds=time.perf_counter() - t0)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs only on a "
              "GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import graph_embed_tpu_torch as gp
    from graph_embed_tpu_torch.graph import synth

    dev = torch.device("cuda", 0)
    smi = phase_env(torch)
    phase_build()

    t0 = time.perf_counter()
    g = synth.mesh3d(MESH_SIDE)
    res = gp.partition_hierarchy(g, 0.1, emit_graphs=True)
    emit(phase="setup", graph=f"mesh3d({MESH_SIDE})", n=g.n,
         stored_entries=g.num_edges, level_sizes=res.level_sizes,
         seconds=time.perf_counter() - t0)
    flat = setup_flat(dev, g)
    lj = setup_lj(dev)
    kernels, slots = phase_kernels(torch, g, res, dev)
    kernels.update(phase_flat_kernels(torch, flat, lj, dev))
    kernels.update(phase_lj_kernels(torch, lj, dev))
    # kernel A's worst error over its paths' shapes
    for mode in ("unit", "bf16x"):
        name = f"edge_spmm[{mode}]"
        other = kernels.pop(f"{name} flat" if mode == "unit"
                            else f"{name} slots")
        for key in ("max_abs_err", "max_err_over_scale"):
            kernels[name][key] = max(kernels[name][key], other[key])
    entry = phase_entry(torch, slots)
    phase_reference(torch, dev)
    launches, f32_wall = phase_main(torch, g, dev, 0.1)
    flat_launches = phase_flat(torch, flat, dev)
    lj_launches = phase_lj(torch, lj, dev)
    phase_bf16_embed(torch, g, dev, f32_wall)
    phase_determinism(torch, flat, lj, dev)
    phase_cli(dev)
    mesh_path = flat_launches[f"mesh3d({MESH_SIDE})"]
    rmat_path = flat_launches["rmat(20,8)"]
    linlog_path = flat_launches["rmat(20,8) linlog"]
    launches["fused_step"] = (mesh_path["fused_step"]
                              + rmat_path["fused_step"])
    launches["edge_linlog"] = linlog_path["edge_linlog"]
    launches["sampled_repulsion"] = linlog_path["sampled_repulsion"]
    launches["edge_spmm[bf16x]"] = lj_launches["community bf16"][
        "edge_spmm[bf16x]"]
    launches["edge_spmm[exact]"] = lj_launches["community tiered nohubs"][
        "edge_spmm[exact]"]
    launches["edge_spmm[vnull]"] = entry["edge_spmm[vnull]"]

    cu = "graph_embed_tpu_torch/csrc/edge_spmm.cu"
    ref = "graph_embed_tpu/ops/pallas/edge_spmm.py"
    sources = {"edge_spmm[unit]": (cu, f"{ref}:1247"),
               "edge_spmm[weighted]": (cu, f"{ref}:1280"),
               "edge_spmm[bf16x]": (cu, f"{ref}:1247"),
               "edge_spmm[exact]": (cu, f"{ref}:1335"),
               "edge_spmm[vnull]": (cu, f"{ref}:992"),
               "bucket_repulsion": (
                   "graph_embed_tpu_torch/csrc/bucket_repulsion.cu",
                   "graph_embed_tpu/forceatlas/multilevel_tiled.py:258,295,"
                   "354"),
               "sampled_repulsion": (
                   "graph_embed_tpu_torch/csrc/repulsion.cu",
                   "graph_embed_tpu/ops/pallas/repulsion.py:76"),
               "fused_step": ("graph_embed_tpu_torch/csrc/fused_step.cu",
                              "graph_embed_tpu/ops/pallas/fused_step.py:85"),
               "edge_linlog": (cu, f"{ref}:203")}
    summary = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=int(launches[name]),
                    **{k: kernels[name][k] for k in (
                        "max_abs_err", "max_err_over_scale", "ms",
                        "plain_ms")})
               for name, (src, rep) in sources.items()]
    print(smi)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
