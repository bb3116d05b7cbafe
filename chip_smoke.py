#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card.

    python3 chip_smoke.py

Phases, one JSON line each:
  env       the card (nvidia-smi name and power limit), torch and CUDA
            versions; TF32 matmuls must be off (the gram repulsion needs
            full-float32 products);
  build     nvcc build of graph_embed_tpu_torch/csrc and its seconds;
  kernels   kernel A (unit and weighted) and kernel B against their plain
            PyTorch versions on the card, at the shapes the main path gives
            them: the level-0 slot layout of mesh3d(128) and its first
            Galerkin level; every output element within RTOL of its own
            sum of |terms|; median times from CUDA events;
  reference the port's embed on the card against its plain versions on
            the CPU, on a small graph from one warm start;
  main      embed_graph on mesh3d(128) (2.1M vertices, 12.5M stored
            entries), dim 3, coarsening factor 0.1, the embed driver's default
            iteration counts; phase seconds, launch counts of both kernels
            (each must be > 0), finite [n, 3] output with every vertex
            inside its parent ball;
  cli       ``python -m graph_embed_tpu_torch.cli embed`` on a small
            ring-of-cliques file.
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
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)

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
            b_err.append(err)
        ms = cuda_ms(lambda: MT.exact_repulsion_cuda(
            x, layout, params.repel, params.epsilon))
        plain_ms = cuda_ms(lambda: MT.exact_repulsion_plain(
            x, layout, params.repel, params.epsilon), reps=5, warmup=1)
        emit(phase="kernels", kernel="bucket_repulsion", level=level,
             slots=layout.n_slots, ctas=int(layout.exact_meta.shape[0]),
             ms=ms, plain_ms=plain_ms)
        if level == 0:
            b_ms, b_plain_ms = ms, plain_ms
    out["bucket_repulsion"] = dict(max_abs_err=max(b_err), ms=b_ms,
                                   plain_ms=b_plain_ms)
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
    return launches


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
    kernels = phase_kernels(torch, g, res, dev)
    phase_reference(torch, dev)
    launches = phase_main(torch, g, dev, 0.1)
    phase_cli(dev)

    sources = {"edge_spmm[unit]": ("graph_embed_tpu_torch/csrc/edge_spmm.cu",
                                   "graph_embed_tpu/ops/pallas/edge_spmm.py"
                                   ":1247"),
               "edge_spmm[weighted]": (
                   "graph_embed_tpu_torch/csrc/edge_spmm.cu",
                   "graph_embed_tpu/ops/pallas/edge_spmm.py:1280"),
               "bucket_repulsion": (
                   "graph_embed_tpu_torch/csrc/bucket_repulsion.cu",
                   "graph_embed_tpu/forceatlas/multilevel_tiled.py:258,295,"
                   "354")}
    summary = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=int(launches[name]), **kernels[name])
               for name, (src, rep) in sources.items()]
    print(smi)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
