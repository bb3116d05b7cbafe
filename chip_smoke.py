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
            first Galerkin level (B also one size class at a time, with
            each class's slots, members and pairs); kernel A (unit, bf16x,
            stream-only) on the
            community graph's residual CSR, exact on its weighted tiered
            CSR; kernel D on both flat graphs and the community graph (with
            kernel A's residual y_res where there is one); kernel E on
            the rmat graph under linlog, kernel C there at 7, 64 and 300
            samples.  Every
            output element within RTOL of its own sum of |terms| (kernel D:
            f so, x' against the plain update applied to the kernel's own
            f); each kernel's time the median on the card alone
            (``device_ms``: the launches enqueued behind a device sleep, so
            CUDA events see no host dispatch), the host's enqueue time
            beside it; the plain versions and torch.sparse.mm, which wait
            on the card inside, by CUDA events around the call;
  entry     ``spmv_windowed`` under each of the reference's variant names
            and ``spmv_windowed_v5``, once each on the slot CSRs, each
            output held to the plain version of the mode it routes to;
  reference the port on the card against its plain versions on the CPU
            from one warm start: the embed on a small graph, and five flat
            tiled steps (fused, linlog, a tiered plan, x_precision='bf16')
            on injected sample ids; the portable refinement's ml_forces on
            the first two levels of mesh3d(12) under gram, exact and
            linlog (each element within RTOL of its rounding scale), five
            force_atlas_multilevel iterations (plain and linlog) and one
            centroids flat step;
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
  bench     bench_torch.py's timed loop (``time_plan``) on the flat
            phase's two plans, which are bench.py's workloads: per
            workload the host-clock stored entries per second (median of 5
            calls of 20 iterations, each closed by a host readback), the
            CUDA-event ms per iteration of the same calls, the card-alone
            and host-enqueue ms of one call (``device_ms``), peak device
            memory and the launches, exactly kernel D (and A unit on rmat)
            once per iteration; finite coordinates;
  lj        the flat step on the LJ phase's six plans: host seconds of
            prepare_tiled, ms per iteration and stored entries per second
            as in the flat phase, launches (bf16x and exact must run);
  bf16 embed  embed_graph on mesh3d(128) with x_precision='bf16' in both
            params: phase seconds beside the f32 embed's, bf16x launches in
            the level-0 refine;
  portable embed  embed on the main phase's hierarchy with
            refine_backend='portable' (the within-aggregate repulsion on
            kernel B over the member tables' slot view): phase seconds and
            launches per span, level 0's refine ms per iteration, kernel A
            in the refine phases and kernel B once an iteration in each,
            finite [n, 3] output inside the parent balls, layout stress
            beside the main embed's;
  linlog embed  the same with linlog in both params (every level refines
            through force_atlas_multilevel): the same fields, and kernel E
            in the refine phases; then one level-0 portable force
            evaluation split by CUDA events (kernel B's repulsion per size
            class and in all, the attraction, the whole ml_forces); then
            kernels A, B and E against their plain versions at both
            embeds' shapes, kernel B on each level's member tables and on
            a partition with the 1,024-4,096 classes (a last table of
            2,927 members) against the float64 sum;
  halo      the halo-sharded flat step at 8 shards (one card, shards
            stacked) on the LJ phase's community graph and partition-ordered
            rmat(20, 8): the plan (blk, B_max, boundary fraction, Ec_max,
            bytes of the ring's slot buffer and groups, host seconds);
            kernel F (the ring's cross-edge attraction) against its plain
            version, and its eight launches over a filled slot buffer, the
            operands checked once, timed on the card alone (enqueued
            behind a device sleep, so no host dispatch between them), as
            its plain version is, then each slot's launch alone with its
            live and padding entries, and the host's enqueue of the eight
            through the per-slot wrapper that checks every slot; the
            whole ring by events around it, on the card alone, and the
            host's time to enqueue it; 3 steps with the ring (overlap=True)
            against 3 with
            the boundary gather from one start and the same samples,
            within 2e-5 of the extent; ms per iteration and stored entries
            per second of both beside the single-shard step's (lj phase);
            then embed(mesh=make_mesh(8), sharding="halo") on mesh3d(128)
            (levels 0 and 1 refine sharded) torch.equal to make_mesh(1);
  replicated  embed(mesh=make_mesh(8)) with the default sharding on levels
            0 and 1 of the main hierarchy (the base case, 1,000
            iterations, on the replicated tiled step, kernel A weighted
            per shard; level 0 refined aggregate-sharded): seconds and
            launches per span, layout stress, 8 shards torch.equal to 1;
            the flat replicated step on the community graph (unit route)
            and on rmat(20, 8) under linlog (kernel E): host seconds of
            the per-shard CSRs, 20 iterations at 8 shards and at 1
            (torch.equal), ms per iteration by events (the attraction
            and the gram repulsion apart) beside the single-shard tiled
            step's; kernels A (weighted, unit) and E on shard 0's CSR of
            each route against their plain versions; radii_inner with
            backend="bucketed" on levels 1-4 torch.equal to the native
            sweep, seconds of each;
  multiprocess  two ranks on the one card under gloo (this script run
            again with --multiprocess-rank; each loads mesh3d(128), its
            hierarchy and the ordered rmat(20, 8) from an .npz this process
            writes under graph_embed_tpu_torch/_build/smoke/), each holding
            4 of 8 shards (parallel.multihost.global_mesh): the halo embed
            of the sharded-embed phase, the replicated phase's truncated
            pipeline and 10 ring-overlap halo steps (dim 3, 64 samples) on
            the ordered rmat graph, each torch.equal on both ranks to the
            stacked 8-shard run here; per rank and path the seconds, the
            seconds staging CUDA tensors through the host and in the
            collectives, and the launches (kernels A, B and F each > 0);
            the halo step's ms per iteration beside the stacked step's;
  profile   utils.profiling.trace around 20 iterations of the rmat linlog
            flat step and one level-0 slot-space refine of mesh3d(128): the
            trace (chiprun_out/chip_smoke_trace/) must name kernels C, E
            and B with CUDA time; each one's calls and CUDA ms per call
            beside its device_ms from the kernels phase;
  determinism  two embed_graph runs on mesh3d(12) (random init, then a warm
            start), two runs of the mesh3d(128) flat step and two of the
            community graph's bf16 step, and the halo base case of a small
            graph (mesh_min_n=1, 200 iterations) on 1 and 8 shards; two
            portable embeds of mesh3d(12), a checkpointed embed resumed
            from its base level against a fresh one, and two runs of
            embed_via over any_to_multilevel(embed_via_minimization) on
            mesh3d(5) (with their seconds): torch.equal;
  cli       ``python -m graph_embed_tpu_torch.cli embed`` on a small
            ring-of-cliques file;
  device partition  mesh3d(128) on the card without its host COO: ``auto``
            picks the device coarsener, whose hierarchy must equal the
            setup's native one at every level (torch.equal), and the
            device Galerkin chain the native emitted chain; the same
            hierarchy check on the unit-weight rmat(20, 8) (absorb
            rounds); the seconds of each beside the native hierarchy's;
            then embed_graph on the card-only mesh3d(128) (device
            coarsener, build_galerkin_chain, embed), its stress within 1%
            of the main embed's;
  run-tests ``cli run-tests`` on synth:planted:200:500:0.05:0.0001 with
            -communities -heuristics: one record, its two modularities
            within 1e-5 of float64 numpy on the same partitions;
  embedder  ``cli embedder`` on mesh3d(128)'s pairs as an adjlist (the
            native parser; coords.temp finite, part.temp reading back to
            the printed level sizes), and on the ring of cliques with a
            plot.html of one point per vertex;
  lj scale  the power-law pipeline at LiveJournal scale through its driver,
            ``scripts/lj_scale_run_torch.py``: its prep stage (rmat(22, 8,
            seed=1) rebuilt with unit weights, the native partition and its
            emitted Galerkin chain, host work only) starts in the background
            after the build, from an empty cache; here ``all 22 8`` runs
            the embed on that cache in a subprocess.  Levels [2009212, 72647,
            5532, 1630] with entries [65244308, 46723835, 2089398, 1630] and
            Q within 1e-4 of 0.0256 (the JAX record, BENCHMARKS.md:391),
            sampled buckets in level 0's refinement, kernels A and B in the
            refine spans, every level finite inside its parent balls, layout
            stress within 10% of the JAX record's 0.1769; per-phase seconds,
            spans with their launches, peak device memory.  Then kernel A on
            level 0's slot and sender CSRs (hub rows included) and level 1's
            slot CSR, and kernel B on every exact size class of levels 0 and
            1, against their plain versions (folded into the summary line's
            errors);
  drivers   ``examples/staged_configs_torch.py`` 1-4 (flat FA with gram
            repulsion, the mesh2d(224) multilevel embed, the tiled step on
            the 200k-vertex power-law graph, the sharded step on the 1M-vertex
            one over this card) and ``examples/quickstart_torch.py``, each in
            a subprocess: its record with ``finite`` true, and its launches
            (kernel D in config 3);
  drivers at scale  the rest of the repo's run drivers, each in a
            subprocess on the LJ-scale prep's cache, their records held
            to the JAX records' host facts: the halo pipeline, host-bound,
            started as soon as that cache is there, so that it runs beside
            the lj scale and drivers phases
            (``scripts/halo_pipeline_run_torch.py 2 1000 22 8 both``: the
            finest two levels, [2009212, 72647] with entries [65244308,
            46723835], the base case on ``make_mesh(1)`` by the halo step
            and by the replicated step, which must take the sampled
            estimator, its peak memory below the dense gram block's 21.1
            GB; kernel A in the base spans, A and B in the refine spans,
            level 0 finite inside its parent balls, stress within 10% of
            the JAX record's 0.170; per-span seconds, the card's busy
            seconds inside each (torch.profiler) and launches, buckets,
            peak memory), beside it in turn the two-process record
            (rmat(17, 8): 1 x 8 and 2 x 4 shards under gloo, equal
            checksums, n, edges, levels and comm model of
            dist_halo_record.jsonl), the quality roster's planted 100k
            entry with its embed and planted precision at caps 0 and 1200
            (aggregates, modularities within 1e-4, level sizes and
            similarity counts of bench_quality.jsonl and
            bench_planted_precision.jsonl), and the kernel holds at these
            drivers' shapes: kernel A on the halo base case's weighted CSR,
            and on the probes' plan of the ordered unit-weight rmat(22, 8)
            kernel A unit on its residual edges and kernel D on the whole
            step; then, alone, the halo scale run (the
            8-shard plan's boundary fraction within 5e-4 of 0.696, the
            one-shard halo step and the flat step in ms per iteration) and
            the LJ step probe (n and entries of the ordered rmat(22, 8),
            ms per iteration).
Each path (main, entry, flat per graph, linlog, bench per workload, lj
per plan, bf16 embed, portable embed, linlog embed, halo per graph, the
sharded embed, the replicated pipeline and each replicated flat run,
each rank's three paths, the device hierarchy, the device chain, the
card-only embed) is driven with the launch counts set to 0 just before
it and read just after; the subprocesses (the CLI, the LJ-scale
driver, the staged configs, the quickstart and the drivers at scale)
report their own.
Then the nvidia-smi line, the kernel summary as one JSON object (per
kernel: launches on its path, error, ms on the card alone, host_ms to
enqueue it, and plain ms as measured, the
bound from this run's shapes -- the larger of the bytes the function must
move over 3.35 TB/s and its operations over 67 TFLOP/s of float32, the
H100 SXM's published peaks -- and the time of one PyTorch call
that computes the same function, where one exists), and the result
line.  Any failed check exits non-zero with no result.  There is
no CPU run: without a CUDA device the script exits 1 at once.
"""

from __future__ import annotations

import itertools
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
# kernel C's sample counts: one staging pass below and at bench.py's 64,
# two above
C_SAMPLES = (7, FLAT_SAMPLES, 300)
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
# the halo phase: shards (scripts/halo_scale_run.py:9), steps compared,
# iterations per timing and timings
HALO_SHARDS = 8
HALO_STEPS = 3
HALO_ITERS = 10
HALO_REPEATS = 3
# refinement iterations per level, embed's default (embed.cpp:793)
REFINE_ITERATIONS = 100
# kernel B's held partition: (smallest, largest, count) of its aggregates'
# sizes, from one-member aggregates to a last table 2,928 wide
B_SIZES = ((1, 1, 200), (2, 32, 2000), (33, 512, 120), (513, 2048, 24),
           (2049, 2927, 6), (2927, 2927, 1))
# the multiprocess phase: ranks on the one card, their work directory
# (inputs, rendezvous, results) and the seconds they may take
MP_RANKS = 2
MP_DIR = os.path.join(ROOT, "graph_embed_tpu_torch", "_build", "smoke",
                      "multiprocess")
MP_TIMEOUT = 300
# the LJ-scale phase: scripts/lj_scale_run_torch.py on rmat(22, 8, seed=1)
# with unit weights, its cache directory, the JAX record's hierarchy, Q and
# stress (BENCHMARKS.md:380-396), the stress gap allowed (the two random
# streams differ), and the seconds its stages may take
LJ_SCALE = ("22", "8")
LJ_SCALE_CACHE = os.path.join(ROOT, ".lj_cache", "torch", "rmat22_8")
LJ_SCALE_LEVELS = [2009212, 72647, 5532, 1630]
LJ_SCALE_ENTRIES = [65244308, 46723835, 2089398, 1630]
LJ_SCALE_Q = 0.0256
LJ_SCALE_STRESS = 0.1769
LJ_SCALE_STRESS_GAP = 0.10
LJ_SCALE_TIMEOUT = 600
# the staged configs and the quickstart: the seconds each may take
DRIVER_TIMEOUT = 300
# the drivers at scale phase, on the LJ-scale cache: the halo pipeline
# (the finest two levels, 1,000 base iterations, both arms) and its JAX
# record's levels, entries and stress (BENCHMARKS.md:617-623), the 8-shard
# plan's boundary fraction at rmat(22, 8) (BENCHMARKS.md:573), the
# two-process record's scale, and the quality tools' arguments; the JAX
# records they are held to; the seconds each driver may take
PIPE_ARGS = ("2", "1000", *LJ_SCALE, "both")
PIPE_LEVELS = LJ_SCALE_LEVELS[:2]
PIPE_ENTRIES = LJ_SCALE_ENTRIES[:2]
PIPE_STRESS = 0.170
PLAN8_BOUNDARY_FRACTION = 0.696
PLAN8_GAP = 5e-4
DIST_SCALE = "17"
DIST_RECORD = os.path.join(ROOT, "dist_halo_record.jsonl")
ROSTER_ARGS = ("--only", "synth:planted:200", "--embed", "--louvain-max-n",
               "0")
ROSTER_RECORD = os.path.join(ROOT, "bench_quality.jsonl")
PLANTED_CAPS = "0,1200"
PLANTED_RECORD = os.path.join(ROOT, "bench_planted_precision.jsonl")
AT_SCALE_DIR = os.path.join(ROOT, "graph_embed_tpu_torch", "_build", "smoke",
                            "drivers_at_scale")
AT_SCALE_TIMEOUT = 600
# the halo pipeline's replicated base case would hold a dense float32
# [n, n] gram block on one shard; its peak memory must stay below it
PIPE_DENSE_BYTES = 4 * PIPE_LEVELS[1] ** 2
# the profiler's card clock against the host's: the card's busy seconds
# inside a span may pass the span's host seconds by this share
BUSY_SLACK = 0.01
# the probes' default sender block and window (scripts/lj_step_probe.py)
PROBE_SHAPE = 8192
# the subprocesses' standard output and error, one pair of files per run
SCRIPT_LOGS = os.path.join(ROOT, "graph_embed_tpu_torch", "_build", "smoke",
                           "logs")
_SCRIPT_RUNS = itertools.count()
# the profile phase's trace directory
TRACE_DIR = os.path.join(ROOT, "chiprun_out", "chip_smoke_trace")
# the card's peaks for the bounds (NVIDIA's data sheet, H100 SXM at
# 700 W): HBM bytes per second, float32 operations per second off the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def pair_ops(d: int) -> int:
    """Operations of one repulsion pair: d differences, d products and d - 1
    sums for d^2, clamp, rsqrt or sqrt and divide, the cube and weight (5),
    and d multiply-adds (2 d)."""
    return 4 * d + 4


def bound(nbytes: float, ops: float) -> dict:
    """The least time of a function on the card: the larger of its bytes
    over HBM_BYTES_PER_S and its operations over F32_OPS_PER_S."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / F32_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_b, t_o),
                bound_by="bytes" if t_b >= t_o else "operations",
                bytes=int(nbytes), ops=int(ops))


def spmv_bound(csr, d: int, x_row_bytes: int | None = None) -> dict:
    """y = A x once: indptr, the column indices (and weights), every row
    of x read once, y written once; a multiply-add per entry and
    coordinate (an add in the unit modes)."""
    weighted = csr.w is not None
    x_row_bytes = 4 * d if x_row_bytes is None else x_row_bytes
    nbytes = (4 * (csr.n_rows + 1) + 4 * csr.nnz * (2 if weighted else 1)
              + x_row_bytes * csr.n_cols + 4 * d * csr.n_rows)
    return bound(nbytes, csr.nnz * d * (2 if weighted else 1))


def library_spmm_ms(torch, csr, x) -> float:
    """One PyTorch call computing y = A x: torch.sparse.mm on a
    sparse_csr_tensor of the same CSR (the yardstick; the port never
    calls it), checked against the plain version first."""
    import dataclasses

    from graph_embed_tpu_torch.ops import edge_spmm as ES

    vals = (csr.w if csr.w is not None else
            torch.ones(csr.nnz, dtype=torch.float32, device=x.device))
    A = torch.sparse_csr_tensor(csr.indptr, csr.col, vals,
                                size=(csr.n_rows, csr.n_cols))
    y = torch.sparse.mm(A, x)
    want = ES.spmv_plain(x, csr)
    wabs = csr if csr.w is None else dataclasses.replace(csr, w=csr.w.abs())
    _, ratio = scaled_err(y, want, ES.spmv_plain(x.abs(), wabs))
    emit(phase="kernels", kernel="library torch.sparse.mm", rows=csr.n_rows,
         nnz=csr.nnz, max_err_over_scale=ratio)
    require(ratio <= 10 * RTOL, "torch.sparse.mm computes the same y = A x")
    return cuda_ms(lambda: torch.sparse.mm(A, x))


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


def device_ms(fn, reps: int = 20, warmup: int = 3) -> tuple[float, float]:
    """(ms of ``fn`` on the card alone, ms the host takes to enqueue it):
    ``utils.profiling.device_ms``, which ``bench_torch.py`` times with too
    (scripts/torch_kernel_ab.py reads it here)."""
    from graph_embed_tpu_torch.utils.profiling import device_ms as on_card

    return on_card(fn, reps=reps, warmup=warmup)


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
    """The kernels (nvcc) and the native libraries (g++: the coarsener,
    the greedy partitioner, the edge-list parser), each from the
    checkout's sources."""
    from graph_embed_tpu_torch.native import coarsen_lib, fastload, greedy_lib
    from graph_embed_tpu_torch.ops import cuda

    t0 = time.perf_counter()
    report = cuda.build()
    cuda.library()
    usage = [ln.strip() for ln in report.splitlines()
             if "registers" in ln or "spill" in ln]
    t1 = time.perf_counter()
    for lib in (coarsen_lib, fastload, greedy_lib):
        lib._lib()
    emit(phase="build", seconds=t1 - t0, ptxas=usage,
         native_seconds=time.perf_counter() - t1)


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
        ms, host_ms = device_ms(lambda: ES.spmv_cuda(x, csr))
        plain_ms = cuda_ms(lambda: ES.spmv_plain(x, csr))
        emit(phase="kernels", kernel=name, level=level, rows=csr.n_rows,
             nnz=csr.nnz, max_abs_err=err, max_err_over_scale=ratio,
             rtol=RTOL, ms=ms, host_ms=host_ms, plain_ms=plain_ms)
        require(ratio <= RTOL, f"{name} agrees with its plain version")
        out[name] = dict(max_abs_err=err, max_err_over_scale=ratio, ms=ms,
                         host_ms=host_ms, plain_ms=plain_ms,
                         **spmv_bound(csr, 3),
                         library_ms=library_spmm_ms(torch, csr, x))
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
        ms, host_ms = device_ms(lambda: MT.exact_repulsion_cuda(
            x, layout, params.repel, params.epsilon))
        plain_ms = cuda_ms(lambda: MT.exact_repulsion_plain(
            x, layout, params.repel, params.epsilon), reps=5, warmup=1)
        # member pairs of the exact buckets; the members' x and weights
        # read once, the task table once, every exact slot's force written
        # once
        exact = [b_class_counts(b) for b in layout.buckets if not b.sampled]
        pairs = sum(c["member_pairs"] for c in exact)
        b_bound = bound(sum(16 * c["member_slots"] + 12 * c["slots"]
                            for c in exact)
                        + 16 * layout.exact_meta.shape[0],
                        pairs * pair_ops(3))
        emit(phase="kernels", kernel="bucket_repulsion", level=level,
             slots=layout.n_slots, table_rows=int(layout.exact_meta.shape[0]),
             ms=ms, host_ms=host_ms, plain_ms=plain_ms, **b_bound)
        b_classes(torch, layout, x, params, level)
        if level == 0:
            b_ms, b_host_ms, b_plain_ms, b0_bound = (ms, host_ms, plain_ms,
                                                     b_bound)
    out["bucket_repulsion"] = dict(
        max_abs_err=max(e for e, _ in b_err),
        max_err_over_scale=max(r for _, r in b_err), ms=b_ms,
        host_ms=b_host_ms, plain_ms=b_plain_ms, library_ms=None, **b0_bound)
    return out, slots


def b_class_counts(b) -> dict:
    """One bucket's slots and member slots; the pairs a kernel evaluates
    that runs every slot against every slot of its aggregate, those one
    that runs members against members evaluates, and the member pairs
    (i != j)."""
    c = b.counts.double()
    return dict(S=b.S, aggregates=b.m_b, slots=b.m_b * b.S,
                member_slots=int(c.sum()), pairs_all_slots=b.m_b * b.S * b.S,
                pairs_members=int((c * c).sum()),
                member_pairs=int((c * (c - 1)).sum()))


def class_table(layout, S: int):
    """The layout with kernel B's table restricted to one size class
    (column 1 of every table row holds its class, negated in the rows that
    write zeros)."""
    import dataclasses

    meta = layout.exact_meta
    return dataclasses.replace(
        layout, exact_meta=meta[meta[:, 1].abs() == S].contiguous())


def b_classes(torch, layout, x, params, level: int) -> list:
    """Kernel B on one size class at a time (``class_table``), timed on the
    card alone, beside the class's counts (``b_class_counts``).  One JSON
    line per class; returns them."""
    from graph_embed_tpu_torch.forceatlas import multilevel_tiled as MT

    lines = []
    for b in layout.buckets:
        if b.sampled:
            continue
        one = class_table(layout, b.S)
        ms, host_ms = device_ms(lambda: MT.exact_repulsion_cuda(
            x, one, params.repel, params.epsilon))
        line = dict(phase="kernels", kernel="bucket_repulsion class",
                    level=level, table_rows=int(one.exact_meta.shape[0]),
                    **b_class_counts(b), ms=ms, host_ms=host_ms)
        emit(**line)
        lines.append(line)
    return lines


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
    ms, host_ms = device_ms(lambda: ES.spmv_bf16x_cuda(xp, csr, d))
    res = dict(max_abs_err=err, max_err_over_scale=ratio, ms=ms,
               host_ms=host_ms,
               plain_ms=cuda_ms(lambda: ES.spmv_bf16x_plain(xp, csr, d),
                                reps=5, warmup=1),
               unit_ms=device_ms(lambda: ES.spmv_cuda(x, csr))[0],
               pack_ms=device_ms(lambda: ES.pack_x_bf16(x))[0],
               **spmv_bound(csr, d, x_row_bytes=4 * ((d + 1) // 2)),
               library_ms=library_spmm_ms(torch, csr,
                                          ES.unpack_x_bf16(xp, d)))
    emit(phase="kernels", kernel="edge_spmm[bf16x]", **fields,
         **{k: res[k] for k in ("ms", "host_ms", "plain_ms", "unit_ms",
                                "pack_ms", "bound_ms", "library_ms")})
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
    # the unit mode's loads and a written y, no arithmetic
    ms, host_ms = device_ms(lambda: ES.spmv_null_cuda(x, csr))
    out["edge_spmm[vnull]"] = dict(
        max_abs_err=0.0, max_err_over_scale=0.0, ms=ms, host_ms=host_ms,
        plain_ms=cuda_ms(lambda: ES.spmv_null_plain(x, csr)),
        **dict(spmv_bound(csr, 3), ops=0), library_ms=None)
    emit(phase="kernels", kernel="edge_spmm[vnull]", graph="community_rmat",
         rows=csr.n_rows, nnz=csr.nnz, ms=ms, host_ms=host_ms,
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
    ms, host_ms = device_ms(lambda: ES.spmv_cuda(x, csr))
    out["edge_spmm[exact]"] = dict(
        max_abs_err=err, max_err_over_scale=ratio, ms=ms, host_ms=host_ms,
        plain_ms=cuda_ms(lambda: ES.spmv_plain(x, csr), reps=5, warmup=1),
        **spmv_bound(csr, 3), library_ms=library_spmm_ms(torch, csr, x))
    emit(phase="kernels", kernel="edge_spmm[exact]",
         graph="community_rmat tiered nohubs",
         ms=ms, host_ms=host_ms,
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


def setup_flat(dev, mesh=None) -> dict:
    """The flat step's graphs on the card, each with its tiled plan:
    {name: (graph, TiledFA, prepare seconds)}, plus 'rmat_linlog'; without
    ``mesh`` the rmat plans alone."""
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
        if g is None:
            continue
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


def lj_graphs(dev) -> tuple:
    """The LJ phase's two graphs on the card: community_rmat(512, 22, 8)
    and rmat(20, 8) put in partition order with its own hierarchy."""
    import numpy as np

    import graph_embed_tpu_torch as gp

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
    return cg.to(dev), og.to(dev)


def setup_lj(dev, graphs: tuple | None = None) -> dict:
    """The LJ phase's plans on the card: {name: (graph, TiledFA, params,
    prepare seconds)}.  The community graph (``lj_graphs``, or ``graphs``)
    is planned four ways, the partition-ordered rmat graph two."""
    import torch

    from graph_embed_tpu_torch.forceatlas import tiled as TL

    cg, og = lj_graphs(dev) if graphs is None else graphs
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
    """The flat step on each LJ plan; launches per plan.  Each plan's ms
    per iteration joins its entry of ``lj``."""
    from graph_embed_tpu_torch.ops import cuda

    launches = {}
    for name, (g, tfa, params, prep) in list(lj.items()):
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
        lj[name] = (g, tfa, params, prep, ms)
        emit(phase="lj", graph=name, n=g.n, stored_entries=g.num_edges,
             prepare_tiled_seconds=prep, iterations=FLAT_ITERS,
             repeats=FLAT_REPEATS, ms_per_iteration=ms,
             ms_per_iteration_all=times,
             entries_per_second=g.num_edges / (ms / 1e3),
             launches=path)
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


def hold_flat_plan(torch, g, tfa, params, gen, dev, **fields) -> dict:
    """Kernel A on a tiled plan's residual edges (where it has any, hub
    rows included) and kernel D on the whole step, each against its plain
    version on inputs drawn from ``gen``: {"inputs": (x, f_prev, sample
    ids, A's output or None), kernel: (max_abs_err, max_err_over_scale)}."""
    from graph_embed_tpu_torch.ops import edge_spmm as ES
    from graph_embed_tpu_torch.ops import fused_step as FS
    from graph_embed_tpu_torch.ops import repulsion as RP

    x = torch.rand((g.n, 3), generator=gen, device=dev) * 2 - 1
    fprev = torch.rand((g.n, 3), generator=gen, device=dev) * 2 - 1
    idx = RP.draw_samples(g.n, params.num_negative_samples, gen, dev)
    out = {}
    y_res = None
    if tfa.csr is not None:
        y_res = ES.spmv_cuda(x, tfa.csr)
        want = ES.spmv_plain(x, tfa.csr)
        scale = ES.spmv_plain(x.abs(), tfa.csr)   # unit weights
        torch.cuda.synchronize()
        out["edge_spmm[unit]"] = hold(
            "edge_spmm[unit]", y_res, want, scale, rows=tfa.csr.n_rows,
            nnz=tfa.csr.nnz, hub_rows=int(tfa.csr.hub_rows.numel()),
            **fields)
        del want, scale
    rest = (tfa.deg_w_att, tfa.deg_p1, idx, params)
    got_x, got_f = FS.fa_step_fused_cuda(x, fprev, tfa.dia_w, tfa.dia_off,
                                         y_res, *rest)
    plain = (x, tfa.dia_w, tfa.dia_offsets, y_res, *rest)
    want_f = FS.step_forces_plain(*plain)
    scale_f = FS.step_forces_plain(*plain, absolute=True)
    want_x = FS.speed_update(x, got_f, fprev, params)
    torch.cuda.synchronize()
    err, ratio = hold("fused_step", got_f, want_f, scale_f, output="f",
                      dia_offsets=len(tfa.dia_offsets), **fields)
    _, ratio_x = hold("fused_step", got_x, want_x,
                      x.abs() + (want_x - x).abs(), output="x'", **fields)
    out["fused_step"] = (err, max(ratio, ratio_x))
    out["inputs"] = (x, fprev, idx, y_res)
    return out


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
        held = hold_flat_plan(torch, g, tfa, params, gen, dev, graph=name)
        x, fprev, idx, y_res = held["inputs"]
        if tfa.csr is not None:
            err, ratio = held["edge_spmm[unit]"]
            ms, host_ms = device_ms(lambda: ES.spmv_cuda(x, tfa.csr))
            emit(phase="kernels", kernel="edge_spmm[unit]", graph=name,
                 ms=ms, host_ms=host_ms,
                 plain_ms=cuda_ms(lambda: ES.spmv_plain(x, tfa.csr),
                                  reps=5, warmup=1),
                 library_ms=library_spmm_ms(torch, tfa.csr, x),
                 **spmv_bound(tfa.csr, 3))
            prev = out.get("edge_spmm[unit] flat", dict(
                max_abs_err=0.0, max_err_over_scale=0.0))
            out["edge_spmm[unit] flat"] = dict(
                max_abs_err=max(err, prev["max_abs_err"]),
                max_err_over_scale=max(ratio, prev["max_err_over_scale"]))
        dia = (tfa.dia_w, tfa.dia_offsets, tfa.dia_off)
        rest = (tfa.deg_w_att, tfa.deg_p1, idx, params)
        d_err.append(held["fused_step"])
        ms, host_ms = device_ms(lambda: FS.fa_step_fused_cuda(
            x, fprev, dia[0], dia[2], y_res, *rest))
        plain_ms = cuda_ms(lambda: FS.fa_step_fused_plain(
            x, fprev, dia[0], dia[1], y_res, *rest), reps=5, warmup=1)
        # x, f_prev, the DIA weights, y_res, the row sums and degrees and
        # the sample ids read once, x' and f written once; the sample pairs,
        # a multiply-add per DIA offset and coordinate, y_res's add
        n, K = g.n, len(tfa.dia_offsets)
        d_bound = bound(
            4 * n * (3 + 3 + K + (3 if y_res is not None else 0) + 2)
            + 4 * FLAT_SAMPLES + 4 * n * 6,
            n * FLAT_SAMPLES * pair_ops(3) + 2 * K * n * 3
            + (n * 3 if y_res is not None else 0))
        emit(phase="kernels", kernel="fused_step", graph=name, n=g.n,
             dia_offsets=len(tfa.dia_offsets), y_res=y_res is not None,
             ms=ms, host_ms=host_ms, plain_ms=plain_ms, **d_bound)
        if "fused_step" not in out:
            out["fused_step"] = dict(ms=ms, host_ms=host_ms,
                                     plain_ms=plain_ms, library_ms=None,
                                     **d_bound)
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
    # kernel A's weighted bytes; per entry the distance (3 d), its sqrt,
    # clamp, log1p and divide, the weight and attract products (6) and
    # d multiply-adds
    csr = tfa.csr
    ms, host_ms = device_ms(lambda: ES.linlog_cuda(x, tfa.csr, **kw))
    out["edge_linlog"] = dict(
        max_abs_err=err, max_err_over_scale=ratio, ms=ms, host_ms=host_ms,
        plain_ms=cuda_ms(lambda: ES.linlog_plain(x, tfa.csr, **kw), reps=5,
                         warmup=1),
        **bound(spmv_bound(csr, 3)["bytes"], csr.nnz * (5 * 3 + 6)),
        library_ms=None)

    kw = dict(repel=params.repel, eps=params.epsilon)
    c_err = []
    for s in C_SAMPLES:
        idx = RP.draw_samples(g.n, s, gen, dev)
        got = RP.repulsion_sampled_cuda(x, tfa.deg_p1, idx, **kw)
        want = RP.repulsion_sampled_plain(x, tfa.deg_p1, idx, **kw)
        scale = RP.repulsion_sampled_plain(x, tfa.deg_p1, idx,
                                           absolute=True, **kw)
        torch.cuda.synchronize()
        err, ratio = hold("sampled_repulsion", got, want, scale,
                          graph="rmat(20,8)", n=g.n, samples=s)
        ms, host_ms = device_ms(lambda: RP.repulsion_sampled_cuda(
            x, tfa.deg_p1, idx, **kw))
        c = dict(max_abs_err=err, max_err_over_scale=ratio, ms=ms,
                 host_ms=host_ms,
                 plain_ms=cuda_ms(lambda: RP.repulsion_sampled_plain(
                     x, tfa.deg_p1, idx, **kw), reps=5, warmup=1),
                 **bound(4 * g.n * (3 + 1 + 3) + 4 * s,
                         g.n * s * pair_ops(3)),
                 library_ms=None)
        emit(phase="kernels", kernel="sampled_repulsion", graph="rmat(20,8)",
             samples=s, **{k: c[k] for k in ("ms", "host_ms", "plain_ms",
                                              "bound_ms", "bound_by")})
        c_err.append((err, ratio))
        if s == FLAT_SAMPLES:
            out["sampled_repulsion"] = c
    # the summary's times at bench.py's samples, its error the worst
    out["sampled_repulsion"].update(
        max_abs_err=max(e for e, _ in c_err),
        max_err_over_scale=max(r for _, r in c_err))
    emit(phase="kernels", kernel="edge_linlog", graph="rmat(20,8)",
         **{k: out["edge_linlog"][k] for k in ("ms", "host_ms", "plain_ms")})
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
    reference_portable(torch, dev)


def reference_portable(torch, dev) -> None:
    """The portable refinement and centroids repulsion on the card against
    their plain versions on the CPU: ml_forces on the first two levels of
    mesh3d(12) (unit and Galerkin weights) under gram, exact and linlog,
    each element within RTOL of its rounding scale
    (``ml_forces(absolute=True)``); five force_atlas_multilevel iterations
    and one centroids flat step from one warm start, within 2e-3 of the
    extent."""
    import numpy as np

    import graph_embed_tpu_torch as gp
    from graph_embed_tpu_torch.forceatlas import multilevel as PML
    from graph_embed_tpu_torch.graph import synth
    from graph_embed_tpu_torch.ops import cuda

    g = synth.mesh3d(12)
    res = gp.partition_hierarchy(g, 0.1, emit_graphs=True)
    rng = np.random.default_rng(7)
    for level, graph in ((0, g), (1, res.coarse_graphs[0])):
        part = res.levels[level]
        x = torch.from_numpy(rng.uniform(-1, 1, (graph.n, 3)).astype(
            np.float32))
        cA = torch.from_numpy(rng.uniform(-1, 1, (part.num_aggs, 3)).astype(
            np.float32))
        for name, kw in (("gram", {}), ("exact", dict(repulsion="exact")),
                         ("linlog", dict(linlog=True))):
            params = gp.MultilevelFAParams(**kw)
            lay_cpu = PML.prepare_multilevel(graph, part, params)
            pull = PML.external_pull(graph, part, cA, pull=params.pull,
                                     eps=params.epsilon)
            want = PML.ml_forces(x, lay_cpu, pull, params)
            scale = PML.ml_forces(x, lay_cpu, pull, params, absolute=True)
            lay = PML.prepare_multilevel(graph.to(dev), part.to(dev), params)
            before = cuda.LAUNCHES.copy()
            got = PML.ml_forces(x.to(dev), lay, pull.to(dev), params).cpu()
            used = dict(cuda.LAUNCHES - before)
            err, ratio = scaled_err(got, want, scale)
            emit(phase="reference", path="ml_forces", level=level, n=graph.n,
                 repulsion=params.repulsion, linlog=params.linlog,
                 attraction=lay.intra.kind, launches=used, max_abs_err=err,
                 max_err_over_scale=ratio, rtol=RTOL)
            require(ratio <= RTOL, f"the card's ml_forces ({name}, level "
                    f"{level}) agrees with the CPU's")
            require(used.get("edge_linlog" if params.linlog else
                             f"edge_spmm[{lay.intra.kind}]", 0) == 1,
                    f"ml_forces ({name}) launched its attraction kernel")
    part = res.levels[0]
    cA = torch.from_numpy(rng.uniform(-3, 3, (part.num_aggs, 3)).astype(
        np.float32))
    rA = torch.full((part.num_aggs,), 0.5)
    x0 = torch.from_numpy(rng.uniform(-1, 1, (g.n, 3)).astype(np.float32))
    for linlog in (False, True):
        params = gp.MultilevelFAParams(linlog=linlog)
        runs = [gp.force_atlas_multilevel(
                    g, part, cA, rA, 3, iterations=5, params=params,
                    coords0=x0, device=d).cpu()
                for d in ("cpu", dev)]
        err, rel = max_err(runs[1], runs[0])
        emit(phase="reference", path="force_atlas_multilevel", n=g.n,
             linlog=linlog, iterations=5, max_abs_err=err, max_rel_err=rel,
             tol_rel=2e-3)
        require(rel <= 2e-3, "the card's portable refinement (linlog="
                f"{linlog}) agrees with the CPU's")
    params = gp.ForceAtlasParams(repulsion="centroids")
    runs = [gp.force_atlas(g, 3, coords=x0, params=params, iterations=1,
                           device=d).cpu() for d in ("cpu", dev)]
    err, rel = max_err(runs[1], runs[0])
    emit(phase="reference", path="flat step, centroids", n=g.n,
         groups=max(32, g.n // 64), max_abs_err=err, max_rel_err=rel,
         tol_rel=2e-3)
    require(rel <= 2e-3, "the card's centroids flat step agrees with the "
            "CPU's")


def phase_main(torch, g, dev, coarsening: float) -> dict:
    import graph_embed_tpu_torch as gp
    from graph_embed_tpu_torch.harness.runtests import layout_stress
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
         ball_excess=excess, spans=metrics.records,
         level0_refine_ms_per_iteration=level0_refine_ms(metrics.records),
         layout_stress=layout_stress(g, coords))
    return launches, wall, coords


def level0_refine_ms(records: list) -> float:
    """Level 0's refine span over REFINE_ITERATIONS, in ms."""
    level0 = [r for r in records if r["phase"] == "refine"
              and r["level"] == 0][0]
    return level0["seconds"] * 1e3 / REFINE_ITERATIONS


def span_launches(records: list) -> list:
    """Each span record with the kernel launches made inside it (the
    logger's ``launches``; {} where it launched none)."""
    return [dict(rec, launches=rec.get("launches", {})) for rec in records]


def phase_portable_embeds(torch, g, res, dev, main_coords) -> dict:
    """embed on the main phase's mesh3d(128) hierarchy through the portable
    refinement: refine_backend='portable' with the default (gram)
    within-aggregate repulsion, then linlog in both params (every level
    refines through force_atlas_multilevel, kernel E).  Each run is driven
    with the launch counts set to 0 just before it and read just after;
    kernel A must launch in both refine phases, E in the linlog ones, and
    B once an iteration in every refine phase (the within-aggregate
    repulsion).  Phase seconds and launches per span, finite [n, 3]
    output, every vertex inside its parent ball, layout stress beside the
    slot-space embed's (for the record, not a gate).  Then kernels A, B
    and E are held against their plain versions at these embeds' shapes
    (``portable_holds``, whose worst errors it returns)."""
    import graph_embed_tpu_torch as gp
    from graph_embed_tpu_torch.harness.runtests import layout_stress
    from graph_embed_tpu_torch.ops import cuda

    slot_stress = layout_stress(g, main_coords)
    for name, kw in (
            ("portable embed", dict(refine_backend="portable")),
            ("linlog embed", dict(
                base_params=gp.ForceAtlasParams(linlog=True),
                refine_params=gp.MultilevelFAParams(linlog=True)))):
        excess = {}

        def check_level(level, coords, part, centres, radii):
            v2a = part.vertex_to_agg
            dist = torch.linalg.norm(coords - centres[v2a], dim=1)
            slack = 1e-5 * float(centres.abs().max()) + 1e-6
            excess[level] = float((dist - radii[v2a]).max())
            require(excess[level] <= slack, f"{name}: level {level} packs "
                    f"into its parent balls ({excess[level]} > {slack})")
            require(bool(torch.isfinite(coords).all()),
                    f"{name}: level {level} finite")

        metrics = gp.MetricsLogger()
        torch.cuda.synchronize()
        cuda.LAUNCHES.clear()
        t0 = time.perf_counter()
        coords = gp.embed([g] + res.coarse_graphs, res.levels, 3,
                          device=dev, metrics=metrics, on_level=check_level,
                          refine_iterations=REFINE_ITERATIONS, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(cuda.LAUNCHES)
        spans = span_launches(metrics.records)
        require(tuple(coords.shape) == (g.n, 3)
                and bool(torch.isfinite(coords).all()),
                f"{name}: finite [n, 3] coordinates")
        require(sorted(excess) == list(range(len(res.levels))),
                f"{name}: every level checked against its parent balls")
        refine = [sp for sp in spans if sp["phase"] == "refine"]
        require(all(sp["route"] == "portable" for sp in refine),
                f"{name}: every level refines through the portable path")
        on_refine = {}
        for sp in refine:
            for k, v in sp["launches"].items():
                on_refine[k] = on_refine.get(k, 0) + v
        a_launches = sum(v for k, v in on_refine.items()
                         if k.startswith("edge_spmm["))
        require(a_launches > 0, f"{name}: kernel A launched in the refine "
                "phases")
        require(all(sp["launches"].get("bucket_repulsion", 0)
                    == REFINE_ITERATIONS for sp in refine),
                f"{name}: kernel B launched once an iteration in each refine "
                "phase")
        if "linlog" in name:
            require(on_refine.get("edge_linlog", 0) > 0, f"{name}: kernel "
                    "E launched in the refine phases")
        emit(phase=name, n=g.n, stored_entries=g.num_edges,
             level_sizes=res.level_sizes, seconds=wall, launches=launches,
             refine_launches=on_refine, ball_excess=excess, spans=spans,
             level0_refine_ms_per_iteration=level0_refine_ms(spans),
             layout_stress=layout_stress(g, coords),
             slot_space_layout_stress=slot_stress)
    portable_split(torch, g, res, dev)
    return portable_holds(torch, g, res, dev)


def portable_holds(torch, g, res, dev) -> dict:
    """Kernels A, B and E against their plain versions at the shapes the
    portable and linlog embeds give them: each level's intra-aggregate CSR
    (kernel A in unit mode on level 0 and exact mode above it under plain
    FA, kernel E under linlog), each level's within-aggregate repulsion
    (kernel B over the layout's slot view, through ``aggregate_repulsion``,
    against the float64 difference-form sum over the same member tables,
    each element within RTOL of its sum of |terms|), level 0's segment
    sums (the cut-edge pull over the sender CSR, the epilogue's
    members-by-aggregate sums) and the base case's CSR under both params.
    Kernel B is also held on a partition of ``B_SIZES``, which fills
    every class from 8 to 4,096 (a last table 2,928 wide, as
    lj-community's level 0 has).  Returns each kernel's worst (max_abs_err, max_err_over_scale)
    for the summary line."""
    import dataclasses

    import numpy as np

    import graph_embed_tpu_torch as gp
    from graph_embed_tpu_torch import interop
    from graph_embed_tpu_torch.forceatlas import flat as PF
    from graph_embed_tpu_torch.forceatlas import multilevel as PML
    from graph_embed_tpu_torch.ops import cuda
    from graph_embed_tpu_torch.ops import edge_spmm as ES

    gen = torch.Generator(device=dev).manual_seed(5)
    worst = {}

    def rand(rows):
        return torch.rand((rows, 3), generator=gen, device=dev) * 2 - 1

    def held(kernel, got, want, scale, **fields):
        err, ratio = hold(kernel, got, want, scale, **fields)
        prev = worst.get(kernel, (0.0, 0.0))
        worst[kernel] = (max(err, prev[0]), max(ratio, prev[1]))

    def hold_a(csr, x, **fields):
        abs_csr = (csr if csr.w is None
                   else dataclasses.replace(csr, w=csr.w.abs()))
        got = ES.spmv_cuda(x, csr)
        want = ES.spmv_plain(x, csr)
        scale = ES.spmv_plain(x.abs(), abs_csr)
        torch.cuda.synchronize()
        held(f"edge_spmm[{csr.kind}]", got, want, scale, rows=csr.n_rows,
             nnz=csr.nnz, **fields)

    def hold_e(csr, x, params, **fields):
        kw = dict(attract=params.attract, eps=params.epsilon)
        got = ES.linlog_cuda(x, csr, **kw)
        want = ES.linlog_plain(x, csr, **kw)
        scale = ES.linlog_plain(x, csr, absolute=True, **kw)
        torch.cuda.synchronize()
        held("edge_linlog", got, want, scale, rows=csr.n_rows, nnz=csr.nnz,
             **fields)

    def hold_b(members, x, deg_p1, params, **fields):
        kw = dict(repel=params.repel, eps=params.epsilon)
        before = cuda.LAUNCHES["bucket_repulsion"]
        got = PML.aggregate_repulsion(x, members, deg_p1, **kw)
        require(cuda.LAUNCHES["bucket_repulsion"] == before + 1,
                f"aggregate_repulsion made one kernel B launch ({fields})")
        tables = tuple(t.cpu() for t in members)
        x64, w64 = x.cpu().double(), deg_p1.cpu().double()
        want = PML.aggregate_repulsion(x64, tables, w64, exact=True, **kw)
        scale = PML.aggregate_repulsion(x64, tables, w64, exact=True,
                                        absolute=True, **kw)
        held("bucket_repulsion", got.cpu().double(), want, scale,
             rows=x.shape[0], widths=[int(t.shape[1]) for t in tables],
             **fields)

    graphs = [g] + res.coarse_graphs
    for linlog in (False, True):
        params = gp.MultilevelFAParams(linlog=linlog)
        path = "linlog embed" if linlog else "portable embed"
        for level, part in enumerate(res.levels):
            lay = PML.prepare_multilevel(graphs[level].to(dev), part.to(dev),
                                         params)
            x = rand(graphs[level].n)
            hold_b(lay.members, x, lay.deg_loc + 1.0, params, path=path,
                   level=level, table="member tables")
            if linlog:
                hold_e(lay.intra, x, params, path=path, level=level,
                       table="intra-aggregate")
            else:
                hold_a(lay.intra, x, path=path, level=level,
                       table="intra-aggregate")
            if level == 0 and not linlog:
                hold_a(lay.sender_csr, rand(lay.sender_csr.n_cols),
                       path=path, level=level, table="sender (cut-edge pull)")
                hold_a(lay.agg_csr, x, path=path, level=level,
                       table="members by aggregate (epilogue)")
        base = graphs[-1].to(dev)
        base_params = gp.ForceAtlasParams(linlog=linlog)
        csr = PF.FlatAttraction.build(base, base_params).csr
        x = rand(base.n)
        if linlog:
            hold_e(csr, x, base_params, path=path, level=len(res.levels),
                   table="base case")
        else:
            hold_a(csr, x, path=path, level=len(res.levels),
                   table="base case")
    rng = np.random.default_rng(5)
    sizes = np.concatenate([rng.integers(lo, hi + 1, k)
                            for lo, hi, k in B_SIZES])
    v2a = rng.permutation(np.repeat(np.arange(sizes.size), sizes))
    part = interop.partition(v2a.astype(np.int32), sizes.size)
    members = PML.place_members(PML.build_member_buckets(part), part.n, dev)
    w = torch.rand(part.n, generator=gen, device=dev) * 8 + 1
    hold_b(members, rand(part.n), w, gp.MultilevelFAParams(),
           path="size classes", aggregates=int(sizes.size),
           largest=int(sizes.max()))
    return worst


def portable_split(torch, g, res, dev) -> None:
    """Where one portable force evaluation of level 0 goes, by CUDA events
    (median of 10): the within-aggregate repulsion (kernel B over the
    member tables' slot view, built beforehand) of each size class alone
    and of all, the attraction (kernel A), and the whole ml_forces."""
    import graph_embed_tpu_torch as gp
    from graph_embed_tpu_torch.forceatlas import multilevel as PML
    from graph_embed_tpu_torch.ops import edge_spmm as ES

    params = gp.MultilevelFAParams()
    lay = PML.prepare_multilevel(g.to(dev), res.levels[0].to(dev), params)
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.rand((g.n, 3), generator=gen, device=dev) * 2 - 1
    deg_p1 = lay.deg_loc + 1.0

    def repulsion(slots):
        return lambda: PML.aggregate_repulsion(x, slots, deg_p1,
                                               params.repel, params.epsilon)

    classes = [dict(S=int(t.shape[1]), aggregates=int(t.shape[0]),
                    ms=cuda_ms(repulsion(PML.member_slots((t,), g.n, dev)),
                               reps=10))
               for t in lay.members]
    emit(phase="portable refine split", level=0, n=g.n,
         intra_entries=lay.intra.nnz, attraction=lay.intra.kind,
         classes=classes, repulsion_ms=cuda_ms(repulsion(lay.members),
                                               reps=10),
         attraction_ms=cuda_ms(lambda: ES.attraction_spmv(
             x, lay.intra, lay.intra_rowsum), reps=10),
         ml_forces_ms=cuda_ms(lambda: PML.ml_forces(
             x, lay, torch.zeros_like(x), params), reps=10))


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
             entries_per_second=g.num_edges / (ms / 1e3),
             launches=path)
    return launches


def phase_bench(torch, flat: dict, dev) -> None:
    """bench_torch.py's timed loop, in this process, on the flat phase's
    plans of bench.py's two workloads: the host clock's entries/s beside
    the card's view of the same calls, and each path's launches."""
    import math

    import bench_torch as BT
    from graph_embed_tpu_torch.forceatlas import tiled as TL

    t0 = time.perf_counter()
    for workload, name in (("mesh", f"mesh3d({MESH_SIDE})"),
                           ("scattered", "rmat(20,8)")):
        g, tfa, prep = flat[name]
        if workload == "scattered":
            # bench.py plans the rmat at (4096, 4096, 1024), setup_flat at
            # the default shape: both give the reference's n_pad, on which
            # the plan depends, so the plan is the same
            require(TL.reference_shape(g.n, True, "f32",
                                       *BT.SCATTERED_SHAPE)[3]
                    == TL.reference_shape(g.n, True)[3],
                    "bench.py's rmat shape plans as the default one does")
        rec = BT.time_plan(g, tfa, BT.bench_params(FLAT_SAMPLES),
                           iters_per_call=FLAT_ITERS, repeats=FLAT_REPEATS)
        want = {"fused_step": 1}
        if workload == "scattered":
            want["edge_spmm[unit]"] = 1
        require(rec["launches_per_iteration"] == want,
                f"bench {workload}: launches per iteration {want}")
        require(math.isfinite(rec["checksum"]),
                f"bench {workload}: finite coordinates")
        emit(phase="bench", workload=workload, graph=name,
             prepare_tiled_seconds=prep, **rec)
    emit(phase="bench", seconds=time.perf_counter() - t0)


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
    _, tfa, params = lj["community bf16"][:3]
    runs = [drive_steps(torch, tfa, params, dev, 5, seed=9)
            for _ in range(2)]
    require(torch.equal(runs[0], runs[1]),
            "two runs of the community graph's bf16 step are equal")
    from graph_embed_tpu_torch.parallel.mesh import make_mesh

    runs = [gp.embed_graph(g, 3, device=dev, base_iterations=200, seed=7,
                           mesh_min_n=1, sharding="halo",
                           mesh=make_mesh(k, device=dev))[0]
            for k in (1, HALO_SHARDS)]
    require(torch.equal(runs[0], runs[1]), "the halo base case on 1 and 8 "
            "shards is equal")
    determinism_portable(torch, g, dev)
    emit(phase="determinism", embed="mesh3d(12) x2, cold and warm",
         flat=f"mesh3d({MESH_SIDE}) 5 steps x2",
         bf16_flat="community_rmat bf16 5 steps x2",
         halo_base="mesh3d(12), mesh_min_n=1, 200 iterations, 1 vs 8 "
         "shards", equal=True)


def determinism_portable(torch, g, dev) -> None:
    """On mesh3d(12): two portable embeds equal; an embed resumed from its
    checkpointed base level equal to a fresh one; two runs of embed_via
    with any_to_multilevel(embed_via_minimization) equal, with their
    seconds."""
    import shutil

    import graph_embed_tpu_torch as gp
    from graph_embed_tpu_torch.embed.checkpoint import CheckpointStore
    from graph_embed_tpu_torch.graph import synth

    kw = dict(device=dev, base_iterations=2000, seed=7,
              refine_backend="portable")
    runs = [gp.embed_graph(g, 3, **kw)[0] for _ in range(2)]
    require(torch.equal(runs[0], runs[1]), "two portable embeds on the "
            "card are equal")
    res = gp.partition_hierarchy(g, 0.1, emit_graphs=True)
    graphs, k = [g] + res.coarse_graphs, len(res.levels)
    work = os.path.join(ROOT, "graph_embed_tpu_torch", "_build", "smoke",
                        "checkpoint")
    shutil.rmtree(work, ignore_errors=True)
    full = CheckpointStore(os.path.join(work, "full"))
    fresh = gp.embed(graphs, res.levels, 3, store=full, **kw)
    base = CheckpointStore(os.path.join(work, "base"))
    base.save_level(k, **full.load_level(k))
    metrics = gp.MetricsLogger()
    resumed = gp.embed(graphs, res.levels, 3, store=base, metrics=metrics,
                       **kw)
    require(metrics.records[0] == {"phase": "resume", "level": k},
            "the embed resumed from its base level")
    require(torch.equal(resumed, fresh), "the resumed embed equals the "
            "fresh one")
    shutil.rmtree(work, ignore_errors=True)

    small = synth.mesh3d(5)
    sres = gp.partition_hierarchy(small, 0.1, emit_graphs=True)

    def flat(sub, dim, seed=0):
        return gp.embed_via_minimization(sub, dim, iterations=3, seed=seed,
                                         device=dev)

    block = gp.any_to_multilevel(flat)
    walls, outs = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(gp.embed_via([small] + sres.coarse_graphs, sres.levels,
                                 3, block, device=dev, base_iterations=2000,
                                 refine_iterations=REFINE_ITERATIONS,
                                 seed=3))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    require(tuple(outs[0].shape) == (small.n, 3)
            and bool(torch.isfinite(outs[0]).all()),
            "embed_via over the minimization embedder is finite")
    require(torch.equal(outs[0], outs[1]), "two embed_via runs over the "
            "minimization embedder are equal")
    emit(phase="determinism", portable_embed="mesh3d(12) x2",
         resume=f"mesh3d(12) from level {k}",
         embed_via_minimization=f"mesh3d(5), {small.n} vertices, levels "
         f"{sres.level_sizes}, 3 sweeps per aggregate", seconds=walls,
         equal=True)


def halo_steps(torch, g, dev):
    """The halo plan of ``g`` at HALO_SHARDS shards and its two tiled
    steps: (plan, ring-overlap step, collective step, host seconds)."""
    from graph_embed_tpu_torch.parallel import halo as PH
    from graph_embed_tpu_torch.parallel import overlap as OV
    from graph_embed_tpu_torch.parallel.mesh import make_mesh

    params = flat_params()
    mesh = make_mesh(HALO_SHARDS, device=dev)
    t0 = time.perf_counter()
    plan = PH.build_halo_plan(g, HALO_SHARDS, boundary_multiple=128)
    groups = OV.build_overlap_groups(plan)
    t_plan = time.perf_counter() - t0
    t0 = time.perf_counter()
    ov = PH.make_halo_fa_step(
        mesh, plan, 3, params, overlap=True, groups=groups,
        tiles=PH.build_halo_csr(plan, params, local_only=True, device=dev))
    col = PH.make_halo_fa_step(
        mesh, plan, 3, params,
        tiles=PH.build_halo_csr(plan, params, device=dev))
    torch.cuda.synchronize()
    return plan, ov, col, dict(plan_seconds=t_plan,
                               steps_seconds=time.perf_counter() - t0)


def filled_slots(torch, x, plan, ring):
    """The ring's slot buffer [slot, shard, B_max, d] as the forwards leave
    it: slot k of shard s holds the boundary block of shard (s - k) %
    ndev."""
    blocks = x[ring.bidx].view(plan.ndev, plan.B_max, x.shape[1])
    return torch.stack([torch.roll(blocks, k, 0) for k in range(plan.ndev)])


def ring_bound(ring, plan, params, d: int = 3) -> dict:
    """Kernel F over every slot: each live entry's cs and cr (and cw under
    use_weights) read once, each group's live count, each distinct
    endpoint row (sender rows, exported rows; the sender's degree under
    nohubs) once, the per-edge forces written once, padding included; per
    live edge 3 d + 8 operations (the distance, sqrt, clamp, weight,
    attract, divide and mask, d products).  The ring's forwards are copies
    the one-card transport adds: not counted."""
    import numpy as np

    rows = ring.csr.indptr[1:] != ring.csr.indptr[:-1]
    senders = int(rows.sum())
    exported = int(np.asarray(plan.boundary_counts).sum())
    entry = 8 + 4 * bool(params.use_weights)
    sender_row = 4 * d + 4 * bool(params.nohubs)
    return bound(entry * ring.live_edges + 4 * ring.live.numel()
                 + sender_row * senders + 4 * d * exported
                 + 4 * d * ring.cs.numel(), ring.live_edges * (3 * d + 8))


def halo_step_ms(torch, step, x0, draw) -> float:
    """Median ms per iteration of a halo step by CUDA events: HALO_REPEATS
    timings of HALO_ITERS iterations, after one warm-up iteration from
    ``x0``; ``draw()`` gives each iteration's samples."""
    xs, f = step(x0, torch.zeros_like(x0), draw())
    per = []
    for _ in range(HALO_REPEATS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(HALO_ITERS):
            xs, f = step(xs, f, draw())
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b) / HALO_ITERS)
    return statistics.median(per)


def phase_halo(torch, lj: dict, dev) -> dict:
    """The halo phase on the community graph and the ordered rmat graph
    (see the module notes).  Returns the ring_attraction summary and the
    launches of the community overlap run."""
    from graph_embed_tpu_torch.ops import cuda
    from graph_embed_tpu_torch.parallel import overlap as OV

    out = {}
    for name, single in (("community", "community f32"),
                         ("rmat(20,8) ordered", "rmat(20,8) ordered f32")):
        g = lj[single][0]
        plan, ov, col, host = halo_steps(torch, g, dev)
        ring = ov.ring
        emit(phase="halo", graph=name, stage="plan", ndev=plan.ndev, n=g.n,
             stored_entries=g.num_edges, blk=plan.blk, B_max=plan.B_max,
             boundary_fraction=plan.boundary_fraction, ec_max=ring.ec,
             cross_edges=ring.live_edges,
             slot_buffer_bytes=plan.ndev * plan.ndev * plan.B_max * 3 * 4,
             group_bytes=4 * 4 * ring.cs.numel(), **host)

        # kernel F against its plain version on one layout
        gen = torch.Generator(device=dev).manual_seed(11)
        x = torch.zeros((plan.ndev * plan.blk, 3), device=dev)
        x[: g.n] = torch.rand((g.n, 3), generator=gen, device=dev) * 2 - 1
        params = flat_params()
        got = OV.ring_cross_forces(x, ov.deg_p1, ring, params)
        want = OV.ring_cross_forces_plain(x, ov.deg_p1, ring, params)
        torch.cuda.synchronize()
        # one term per element: its own size is its scale
        err, ratio = hold("ring_attraction", got, want, want.abs(),
                          graph=name, entries=ring.cs.numel(),
                          live=ring.live_edges)
        # kernel F alone: its launches over the eight slots of a slot
        # buffer filled in advance, the operands checked once, timed on the
        # card alone, as its plain version is; it must give the ring's own
        # output.  Beside it the host's enqueue of the eight launches
        # through the public per-slot wrapper, which checks every slot.
        buf = filled_slots(torch, x, plan, ring)
        alone = OV.ring_slot_forces(buf, x, ov.deg_p1, ring, params)
        torch.cuda.synchronize()
        require(torch.equal(alone, got), f"halo {name}: kernel F over a "
                "filled slot buffer gives the ring's output")

        def slots(fn, last, out=None):
            # ``last``: the live counts for the kernel, the mask for plain
            return [fn(buf[k], x, ov.deg_p1, ring.cs[k], ring.cr[k],
                       ring.cw[k], last[k], blk=ring.blk, params=params,
                       **({} if out is None else {"out": out[k]}))
                    for k in range(plan.ndev)]

        ms, host_ms = device_ms(lambda: OV.ring_slot_forces(
            buf, x, ov.deg_p1, ring, params, out=alone))
        _, host_checked_ms = device_ms(lambda: slots(
            OV.slot_forces_cuda, ring.live, torch.empty_like(alone)))
        plain_ms, _ = device_ms(lambda: slots(OV.slot_forces_plain,
                                              ring.mask), reps=5, warmup=1)
        # each slot's launch alone, with its live and padding entries
        live = ring.live.sum(dim=1).tolist()
        per_slot = [dict(slot=k, live=live[k],
                         padding=plan.ndev * ring.ec - live[k],
                         ms=device_ms(lambda k=k: OV.ring_slot_forces(
                             buf, x, ov.deg_p1, ring, params, out=alone,
                             slots=(k,)))[0])
                    for k in range(plan.ndev)]
        # the whole ring (gather, forwards, events, launches): by events
        # around the call, on the card alone, and the host's enqueueing
        ring_ms = cuda_ms(lambda: OV.ring_cross_forces(x, ov.deg_p1, ring,
                                                       params))
        ring_dev_ms, ring_host_ms = device_ms(
            lambda: OV.ring_cross_forces(x, ov.deg_p1, ring, params))
        f_bound = ring_bound(ring, plan, params)
        emit(phase="kernels", kernel="ring_attraction", graph=name, ms=ms,
             host_ms=host_ms, host_ms_checked_per_slot=host_checked_ms,
             plain_ms=plain_ms, slot0_ms=per_slot[0]["ms"],
             slots_1_on_ms=sum(s["ms"] for s in per_slot[1:]),
             slots=per_slot, ring_ms=ring_ms, ring_device_ms=ring_dev_ms,
             ring_host_ms=ring_host_ms, **f_bound)

        # the ring against the gather: one start, the same samples
        x0 = torch.zeros_like(x)
        x0[: g.n] = torch.rand((g.n, 3), generator=gen, device=dev) * 2 - 1
        ids = [ov.draw(gen) for _ in range(HALO_STEPS)]
        runs, paths = [], []
        for step in (ov, col):
            torch.cuda.synchronize()
            cuda.LAUNCHES.clear()
            xs, f = x0, torch.zeros_like(x0)
            for i in range(HALO_STEPS):
                xs, f = step(xs, f, ids[i])
            torch.cuda.synchronize()
            paths.append(dict(cuda.LAUNCHES))
            runs.append(xs[: g.n])
        extent = float(runs[1].abs().max())
        diff = float((runs[0] - runs[1]).abs().max())
        require(bool(torch.isfinite(runs[0]).all()),
                f"halo {name}: finite coordinates")
        require(diff <= 2e-5 * extent, f"halo {name}: the ring agrees with "
                f"the gather ({diff} > 2e-5 * {extent})")
        require(paths[0].get("ring_attraction", 0) == HALO_STEPS * plan.ndev,
                f"halo {name}: kernel F once per slot and step")
        require(paths[0].get("edge_spmm[unit]", 0) > 0
                and paths[1].get("edge_spmm[unit]", 0) > 0,
                f"halo {name}: kernel A runs the tiled attraction")

        # ms per iteration of both, beside the single-shard step's
        times = {label: halo_step_ms(torch, step, x0, lambda: ov.draw(gen))
                 for label, step in (("overlap", ov), ("collective", col))}
        # where a step's time goes: the attraction (kernel A), the ring
        # (kernel F with its transport, above), the gram repulsion (plain
        # PyTorch, as the reference's halo.py:547-558 is plain jnp)
        parts = dict(
            attraction_ms=cuda_ms(lambda: col._attraction(x0)),
            local_attraction_ms=cuda_ms(lambda: ov._attraction(x0)),
            ring_ms=ring_ms, ring_device_ms=ring_dev_ms,
            ring_host_ms=ring_host_ms, kernel_f_ms=ms,
            repulsion_ms=cuda_ms(lambda: col._repulsion(x0, ids[0])))
        single_ms = lj[single][4]
        emit(phase="halo", graph=name, stage="steps", steps=HALO_STEPS,
             **parts,
             max_abs_diff=diff, extent=extent, tol=2e-5,
             launches_overlap=paths[0], launches_collective=paths[1],
             iterations=HALO_ITERS, repeats=HALO_REPEATS,
             overlap_ms=times["overlap"],
             collective_ms=times["collective"], single_shard_ms=single_ms,
             overlap_entries_per_second=g.num_edges / (times["overlap"]
                                                       / 1e3),
             collective_entries_per_second=g.num_edges
             / (times["collective"] / 1e3),
             single_shard_entries_per_second=g.num_edges / (single_ms
                                                            / 1e3))
        if name == "community":
            out = dict(max_abs_err=err, max_err_over_scale=ratio, ms=ms,
                       host_ms=host_ms, plain_ms=plain_ms, library_ms=None,
                       **f_bound,
                       launches=paths[0].get("ring_attraction", 0))
    return out


def phase_sharded_embed(torch, g, res, dev):
    """embed(mesh=make_mesh(8), sharding='halo') on mesh3d(128)'s own
    hierarchy: levels of at least 65536 vertices refine with their
    aggregates dealt over the shards; torch.equal to make_mesh(1).
    Returns the 8-shard coordinates."""
    import graph_embed_tpu_torch as gp
    from graph_embed_tpu_torch.ops import cuda
    from graph_embed_tpu_torch.parallel.mesh import make_mesh

    sharded = [n for n in res.level_sizes[:-1] if n >= 65536]
    require(len(sharded) >= 2, "levels 0 and 1 refine sharded")
    outs, walls = [], []
    for ndev in (HALO_SHARDS, 1):
        metrics = gp.MetricsLogger()
        torch.cuda.synchronize()
        cuda.LAUNCHES.clear()
        t0 = time.perf_counter()
        outs.append(gp.embed([g] + res.coarse_graphs, res.levels, 3,
                             device=dev, base_iterations=1000, seed=5,
                             mesh=make_mesh(ndev, device=dev),
                             sharding="halo", metrics=metrics))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if ndev == HALO_SHARDS:
            launches = dict(cuda.LAUNCHES)
            spans = metrics.records
    require(bool(torch.isfinite(outs[0]).all()), "finite sharded embed")
    require(torch.equal(outs[0], outs[1]), "the 8-shard embed equals the "
            "1-shard embed")
    for k in ("edge_spmm[unit]", "bucket_repulsion"):
        require(launches.get(k, 0) > 0, f"{k} on the sharded embed path")
    emit(phase="sharded embed", n=g.n, sharded_levels=sharded,
         seconds_8_shards=walls[0], seconds_1_shard=walls[1], equal=True,
         launches=launches, spans=spans)
    return outs[0]


def hold_shard_csr(torch, kernel: str, csr, gen, worst: dict, params=None,
                   **fields) -> None:
    """Kernel A (``params`` None) or E on one shard's CSR against its plain
    version on random coordinates; the worst (max_abs_err,
    max_err_over_scale) per kernel into ``worst``."""
    import dataclasses

    from graph_embed_tpu_torch.ops import edge_spmm as ES

    x = torch.rand((csr.n_cols, 3), generator=gen, device=csr.device) * 2 - 1
    if params is None:
        abs_csr = (csr if csr.w is None
                   else dataclasses.replace(csr, w=csr.w.abs()))
        got, want = ES.spmv_cuda(x, csr), ES.spmv_plain(x, csr)
        scale = ES.spmv_plain(x.abs(), abs_csr)
    else:
        kw = dict(attract=params.attract, eps=params.epsilon)
        got, want = ES.linlog_cuda(x, csr, **kw), ES.linlog_plain(x, csr,
                                                                  **kw)
        scale = ES.linlog_plain(x, csr, absolute=True, **kw)
    torch.cuda.synchronize()
    err, ratio = hold(kernel, got, want, scale, rows=csr.n_rows,
                      nnz=csr.nnz, **fields)
    prev = worst.get(kernel, (0.0, 0.0))
    worst[kernel] = (max(err, prev[0]), max(ratio, prev[1]))


def steps_ms(torch, run) -> float:
    """Median ms per iteration of ``run()`` (FLAT_ITERS iterations) by
    CUDA events over 3 timings, after one warm-up run."""
    run()
    per = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b) / FLAT_ITERS)
    return statistics.median(per)


def replicated_flat(torch, name, g, params, single, dev, worst) -> None:
    """The replicated flat step on ``g`` at HALO_SHARDS shards and at 1:
    host seconds of the per-shard CSRs, FLAT_ITERS iterations of
    ``sharded_force_atlas`` from one seed (torch.equal), launches, ms per
    iteration by events beside the single-shard tiled step's (``single``:
    its TiledFA, same graph and params, this call); kernel A or E held on
    shard 0's CSR."""
    from graph_embed_tpu_torch.ops import cuda
    from graph_embed_tpu_torch.parallel import sharded as PSH
    from graph_embed_tpu_torch.parallel.mesh import make_mesh

    kernel = "edge_linlog" if params.linlog else "edge_spmm[unit]"
    outs, rec = [], {}
    for ndev in (HALO_SHARDS, 1):
        mesh = make_mesh(ndev, device=dev)
        t0 = time.perf_counter()
        tiles = (PSH.build_sharded_edge_tiles(g, ndev, params=params,
                                              device=dev)
                 if params.linlog else
                 PSH.build_sharded_tiles(g, ndev, dia_min_count=None,
                                         params=params, device=dev))
        torch.cuda.synchronize()
        rec[f"build_seconds_{ndev}"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        cuda.LAUNCHES.clear()
        outs.append(PSH.sharded_force_atlas(
            g, 3, mesh=mesh, params=params, iterations=FLAT_ITERS, seed=7,
            device=dev, tiles=tiles))
        torch.cuda.synchronize()
        path = dict(cuda.LAUNCHES)
        require(path.get(kernel, 0) >= FLAT_ITERS * ndev,
                f"replicated {name}: {kernel} on every shard and step")
        step, n_pad = PSH.make_sharded_fa_step_tiled(mesh, tiles, 3, params,
                                                     g.n)
        gen = torch.Generator(device=dev).manual_seed(3)
        x0 = torch.zeros((n_pad, 3), device=dev)
        x0[: g.n] = outs[-1]
        deg = torch.zeros(n_pad, device=dev)
        deg[: g.n] = g.degrees(params.use_weights)

        def run():
            x, f = x0, torch.zeros_like(x0)
            for _ in range(FLAT_ITERS):
                x, f = step(x, f, deg, step.draw(gen))

        rec[f"ms_per_iteration_{ndev}"] = steps_ms(torch, run)
        if ndev == HALO_SHARDS:
            # where an iteration goes: the shards' attraction (kernel A or
            # E and the shard sums), the gram repulsion (plain torch, as
            # the reference's sharded.py:622-652 is plain jnp)
            ids = step.draw(gen)
            rec.update(attraction_ms=cuda_ms(lambda: step._attraction(x0)),
                       repulsion_ms=cuda_ms(lambda: PSH._repulsion(
                           x0, deg + 1.0, g.n, params, ids)))
            launches = path
            rec.update(packing=tiles.packing, sender_block=tiles.sender_block,
                       window=tiles.window, dia_offsets=list(
                           tiles.dia_offsets),
                       shard_entries=[c.nnz for c in tiles.csrs])
            hold_shard_csr(torch, kernel, tiles.csrs[0], gen, worst,
                           params if params.linlog else None,
                           path=f"replicated {name}", shard=0)
        del tiles, step
    require(bool(torch.isfinite(outs[0]).all()), f"replicated {name}: "
            "finite coordinates")
    require(torch.equal(outs[0], outs[1]), f"replicated {name}: "
            f"{HALO_SHARDS} shards equal 1")
    single_ms = steps_ms(torch, lambda: drive_steps(
        torch, single, params, dev, FLAT_ITERS))
    emit(phase="replicated", path="flat step", graph=name, n=g.n,
         stored_entries=g.num_edges, linlog=params.linlog,
         iterations=FLAT_ITERS, equal=True, launches_8_shards=launches,
         single_shard_ms_per_iteration=single_ms, **rec)


def phase_replicated(torch, g, res, lj, flat, main_coords, dev):
    """The replicated multi-shard design, embed(mesh=...)'s default: the
    truncated mesh pipeline (levels 0 and 1 of the main hierarchy; the
    base case runs the replicated tiled step, level 0 refines
    aggregate-sharded), 8 shards torch.equal to 1, per-span seconds and
    launches, layout stress; the flat replicated step on the community
    graph (unit route) and rmat(20, 8) under linlog; the bucketed radii
    on levels 1-4 torch.equal to the native sweep; kernels A and E on one
    shard's CSR of each route against their plain versions.  Returns the
    worst errors (for the summary line) and the pipeline's 8-shard
    coordinates."""
    import graph_embed_tpu_torch as gp
    from graph_embed_tpu_torch.embed import radii as PR
    from graph_embed_tpu_torch.embed.driver import project_to_levels
    from graph_embed_tpu_torch.harness.runtests import layout_stress
    from graph_embed_tpu_torch.ops import cuda
    from graph_embed_tpu_torch.parallel import sharded as PSH
    from graph_embed_tpu_torch.parallel.mesh import make_mesh

    worst = {}
    gen = torch.Generator(device=dev).manual_seed(17)
    t_phase = time.perf_counter()
    graphs, parts = [g, res.coarse_graphs[0]], res.levels[:1]
    base = graphs[1].to(dev)
    n_pad = -(-base.n // HALO_SHARDS) * HALO_SHARDS
    dense_bytes = 4 * (n_pad // HALO_SHARDS) * n_pad
    outs, walls = [], []
    for ndev in (HALO_SHARDS, 1):
        metrics = gp.MetricsLogger()
        torch.cuda.synchronize()
        cuda.LAUNCHES.clear()
        t0 = time.perf_counter()
        outs.append(gp.embed(graphs, parts, 3, device=dev,
                             base_iterations=1000, seed=5,
                             mesh=make_mesh(ndev, device=dev),
                             metrics=metrics))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if ndev == HALO_SHARDS:
            launches = dict(cuda.LAUNCHES)
            spans = span_launches(metrics.records)
    base_span = [sp for sp in spans if sp["phase"] == "base"][0]
    refine = [sp for sp in spans if sp["phase"] == "refine"][0]
    require(base_span["launches"].get("edge_spmm[weighted]", 0) >= 1000
            * HALO_SHARDS, "the replicated base case runs kernel A "
            "weighted on every shard and iteration")
    require(refine["route"] == "sharded"
            and refine["launches"].get("bucket_repulsion", 0) > 0,
            "level 0 refines aggregate-sharded (kernel B)")
    require(tuple(outs[0].shape) == (g.n, 3)
            and bool(torch.isfinite(outs[0]).all()),
            "replicated pipeline: finite [n, 3] coordinates")
    require(torch.equal(outs[0], outs[1]), f"replicated pipeline: "
            f"{HALO_SHARDS} shards equal 1")
    emit(phase="replicated", path="truncated mesh3d(128) pipeline",
         level_sizes=[gr.n for gr in graphs],
         entries=[gr.num_edges for gr in graphs],
         dense_block_bytes=dense_bytes,
         switched_to_sampled=dense_bytes > PSH.DENSE_D2_MAX_BYTES,
         seconds_8_shards=walls[0], seconds_1_shard=walls[1], equal=True,
         launches=launches, spans=spans,
         layout_stress=layout_stress(g, outs[0]))
    pipeline = outs[0]
    del outs
    t0 = time.perf_counter()
    tiles = PSH.build_sharded_tiles(base, HALO_SHARDS, dia_min_count=None,
                                    params=gp.ForceAtlasParams(), device=dev)
    torch.cuda.synchronize()
    require(tiles.packing == "bf16", "the Galerkin level takes the bf16 "
            "packing")
    hold_shard_csr(torch, "edge_spmm[weighted]", tiles.csrs[0], gen, worst,
                   path="replicated base case", shard=0,
                   build_seconds=time.perf_counter() - t0)
    del tiles

    cg, c_tfa = lj["community f32"][:2]
    replicated_flat(torch, "community", cg, flat_params(), c_tfa, dev, worst)
    rg, r_tfa = flat["rmat(20,8) linlog"][:2]
    replicated_flat(torch, "rmat(20,8) linlog", rg, flat_params(linlog=True),
                    r_tfa, dev, worst)

    cs = project_to_levels(main_coords, res.levels)
    all_graphs = [g] + res.coarse_graphs
    radii = []
    for lv in range(1, min(5, len(res.levels))):
        part = res.levels[lv].to(dev)
        r_c = torch.ones(part.num_aggs, device=dev)
        got, sec = {}, {}
        for backend in ("bucketed", "auto"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got[backend] = PR.radii_inner(cs[lv], r_c, all_graphs[lv], part,
                                          backend=backend)
            torch.cuda.synchronize()
            sec[backend] = time.perf_counter() - t0
        require(torch.equal(got["bucketed"], got["auto"]),
                f"level {lv}: the bucketed radii equal the native ones")
        radii.append(dict(level=lv, aggregates=all_graphs[lv].n,
                          bucketed_seconds=sec["bucketed"],
                          native_seconds=sec["auto"]))
    emit(phase="replicated", path="radii_inner bucketed vs native",
         levels=radii, equal=True, seconds=time.perf_counter() - t_phase)
    return worst, pipeline


def halo_flat(torch, mesh, g, dev):
    """HALO_ITERS iterations of the ring-overlap halo step on ``g`` over
    ``mesh`` (dim 3, FLAT_SAMPLES stratified samples, the tiled local
    CSR), drawn from seed 11 as ``halo_force_atlas(..., overlap=True)``
    draws them: (every row's coordinates, ms per iteration by the host
    clock around the synchronized loop)."""
    from graph_embed_tpu_torch.parallel import halo as PH

    params = flat_params()
    plan = PH.build_halo_plan(g, mesh.ndev, boundary_multiple=128)
    tiles = PH.build_halo_csr(plan, params, local_only=True, device=dev,
                              shards=mesh.local_shards)
    step = PH.make_halo_fa_step(mesh, plan, 3, params, overlap=True,
                                tiles=tiles)
    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.zeros((plan.ndev * plan.blk, 3), device=dev)
    x[: g.n] = torch.rand((g.n, 3), generator=gen, device=dev) * 2 - 1
    x = x[step.lo: step.hi]
    f = torch.zeros_like(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HALO_ITERS):
        x, f = step(x, f, step.draw(gen))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / HALO_ITERS
    full = x if mesh.comm is None else mesh.comm.all_gather(x)
    return full[: g.n], ms


def multiprocess_inputs(g, res, rg) -> dict:
    """The ranks' graphs as host arrays: mesh3d(128) and its Galerkin
    levels (``g{i}_*``), its partitions (``p{i}_*``) and the ordered rmat
    graph (``rmat_*``)."""
    import numpy as np

    out = {}
    for name, gr in [(f"g{i}", x) for i, x in enumerate(
            [g] + res.coarse_graphs)] + [("rmat", rg)]:
        s, r, w = gr.to_coo_numpy()
        out.update({f"{name}_s": s, f"{name}_r": r, f"{name}_w": w,
                    f"{name}_n": np.int64(gr.n)})
    for i, p in enumerate(res.levels):
        out[f"p{i}_v2a"] = p.vertex_to_agg_numpy()
        out[f"p{i}_m"] = np.int64(p.num_aggs)
    return out


def multiprocess_rank(rank: int, work: str) -> int:
    """One rank of the multiprocess phase: join the gloo group through
    ``work``, load the inputs, drive the three paths on
    ``global_mesh(shards_per_process=4)``, write the coordinates
    (rank{rank}.npz) and each path's seconds, staging and collective
    seconds and launches (rank{rank}.json)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    import graph_embed_tpu_torch as gp
    from graph_embed_tpu_torch import interop
    from graph_embed_tpu_torch.ops import cuda
    from graph_embed_tpu_torch.parallel import multihost as MH

    dev = torch.device("cuda", 0)
    MH.init_distributed(f"file://{os.path.join(work, 'rendezvous')}",
                        MP_RANKS, rank, backend="gloo")
    mesh = MH.global_mesh(shards_per_process=HALO_SHARDS // MP_RANKS,
                          device=dev)
    require(mesh.process_count == MP_RANKS and mesh.process_index == rank,
            "the rank joined the group")
    data = np.load(os.path.join(work, "inputs.npz"))
    levels = sum(1 for k in data.files if k.endswith("_v2a"))
    graphs, parts = interop.hierarchy(
        [tuple(data[f"g{i}_{k}"] for k in "srw") + (int(data[f"g{i}_n"]),)
         for i in range(levels + 1)],
        [(data[f"p{i}_v2a"], int(data[f"p{i}_m"])) for i in range(levels)])
    rg = interop.graph(data["rmat_s"], data["rmat_r"], data["rmat_w"],
                       int(data["rmat_n"]), device=dev)
    # the phase_sharded_embed and phase_replicated recipes, on this mesh
    runs = {"halo embed": lambda: gp.embed(
                graphs, parts, 3, device=dev, base_iterations=1000, seed=5,
                mesh=mesh, sharding="halo"),
            "replicated pipeline": lambda: gp.embed(
                graphs[:2], parts[:1], 3, device=dev, base_iterations=1000,
                seed=5, mesh=mesh),
            "halo flat": lambda: halo_flat(torch, mesh, rg, dev)}
    coords, rec = {}, {}
    for name, run in runs.items():
        torch.cuda.synchronize()
        cuda.LAUNCHES.clear()
        st, co = mesh.comm.stage_seconds, mesh.comm.collective_seconds
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        rec[name] = dict(seconds=time.perf_counter() - t0,
                         stage_seconds=mesh.comm.stage_seconds - st,
                         collective_seconds=mesh.comm.collective_seconds - co,
                         launches=dict(cuda.LAUNCHES))
        if name == "halo flat":
            out, rec[name]["ms_per_iteration"] = out
        coords[name] = out.cpu().numpy()
    np.savez(os.path.join(work, f"rank{rank}.npz"), **coords)
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    dist.destroy_process_group()
    return 0


def phase_multiprocess(torch, g, res, lj, halo_embed, pipeline, dev) -> None:
    """Two ranks on the one card under gloo (``multiprocess_rank``, this
    script run again), each holding 4 of 8 shards: the halo embed of
    mesh3d(128) and the truncated replicated pipeline against this
    process's stacked 8-shard runs (``halo_embed``, ``pipeline``), and
    the ring-overlap halo flat step on the ordered rmat graph against its
    stacked run here; torch.equal on every rank, each rank's launches of
    kernels A, B and F > 0, ms per iteration beside the stacked step's,
    the seconds of staging and of the collectives."""
    import numpy as np

    from graph_embed_tpu_torch.parallel.mesh import make_mesh

    t_phase = time.perf_counter()
    rg = lj["rmat(20,8) ordered f32"][0]
    stacked = {"halo embed": halo_embed, "replicated pipeline": pipeline}
    stacked["halo flat"], stacked_ms = halo_flat(
        torch, make_mesh(HALO_SHARDS, device=dev), rg, dev)
    os.makedirs(MP_DIR, exist_ok=True)
    for name in os.listdir(MP_DIR):
        os.remove(os.path.join(MP_DIR, name))
    np.savez(os.path.join(MP_DIR, "inputs.npz"),
             **multiprocess_inputs(g, res, rg))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t_spawn = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--multiprocess-rank",
         str(rank), MP_DIR], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for rank in range(MP_RANKS)]
    try:
        # a failed rank leaves the other waiting in a collective: end both
        while any(p.poll() is None for p in procs):
            if (any(p.poll() not in (None, 0) for p in procs)
                    or time.perf_counter() - t_spawn > MP_TIMEOUT):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        logs = [p.communicate() for p in procs]
    for rank, (p, (out, err)) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            print(f"chip_smoke: multiprocess rank {rank} exited "
                  f"{p.returncode}:\n{out[-2000:]}\n{err[-4000:]}",
                  file=sys.stderr)
    require(all(p.returncode == 0 for p in procs), "every rank finished")
    wall = time.perf_counter() - t_spawn
    ranks = []
    for rank in range(MP_RANKS):
        got = np.load(os.path.join(MP_DIR, f"rank{rank}.npz"))
        with open(os.path.join(MP_DIR, f"rank{rank}.json")) as f:
            rec = json.load(f)
        for name, want in stacked.items():
            require(torch.equal(torch.from_numpy(got[name]), want.cpu()),
                    f"multiprocess {name}: rank {rank} of {MP_RANKS} x "
                    f"{HALO_SHARDS // MP_RANKS} shards equals the stacked "
                    f"{HALO_SHARDS} shards")
        total = {}
        for path in rec.values():
            for k, v in path["launches"].items():
                total[k] = total.get(k, 0) + v
        for kernel in ("bucket_repulsion", "ring_attraction"):
            require(total.get(kernel, 0) > 0, f"rank {rank} launched "
                    f"{kernel}")
        require(sum(v for k, v in total.items() if k.startswith("edge_spmm"))
                > 0, f"rank {rank} launched kernel A")
        ranks.append(dict(rank=rank, paths=rec))
    emit(phase="multiprocess", ranks=MP_RANKS, backend="gloo",
         shards_per_process=HALO_SHARDS // MP_RANKS,
         paths=list(stacked), equal=True,
         halo_flat=dict(graph="rmat(20,8) ordered", n=rg.n,
                        stored_entries=rg.num_edges, iterations=HALO_ITERS,
                        stacked_ms_per_iteration=stacked_ms,
                        ms_per_iteration=[r["paths"]["halo flat"][
                            "ms_per_iteration"] for r in ranks]),
         per_rank=ranks, ranks_seconds=wall,
         seconds=time.perf_counter() - t_phase)


def profiled_kernels(prof) -> dict:
    """{kernel name: (calls, CUDA ms)} of kernels C, E and B in a
    profiler's ``key_averages()``, matched by their CUDA function names
    (csrc/repulsion.cu, edge_spmm.cu, bucket_repulsion.cu)."""
    import re

    names = {"sampled_repulsion": "repulsion_kernel",
             "edge_linlog": "linlog_kernel",
             "bucket_repulsion": "bucket_repulsion_kernel"}
    events = prof.key_averages()
    out = {}
    for kernel, fn in names.items():
        pat = re.compile(rf"(?<![A-Za-z0-9_]){fn}\b")
        calls, us = 0, 0.0
        for evt in events:
            if pat.search(evt.key):
                calls += evt.count
                us += getattr(evt, "device_time_total", None) or getattr(
                    evt, "cuda_time_total", 0.0)
        out[kernel] = (calls, us / 1e3)
    return out


def phase_profile(torch, g, res, flat, kernels, main_coords, dev) -> None:
    """``utils.profiling.trace`` around FLAT_ITERS iterations of the rmat
    linlog flat step (kernels E and C) and one level-0 slot-space refine
    of mesh3d(128) (kernel B): the trace must name the three kernels with
    CUDA time (no fallback where the profiler sees no device); each one's
    calls and CUDA ms per call beside its ``device_ms`` from the kernels
    phase."""
    from graph_embed_tpu_torch.embed.driver import project_to_levels
    from graph_embed_tpu_torch.forceatlas import multilevel_tiled as MT
    from graph_embed_tpu_torch.utils import profiling
    from graph_embed_tpu_torch.utils.params import MultilevelFAParams
    from graph_embed_tpu_torch.utils.timing import MetricsLogger

    t0 = time.perf_counter()
    rg, tfa = flat["rmat(20,8) linlog"][:2]
    params = flat_params(linlog=True)
    part = res.levels[0].to(dev)
    level0 = g.to(dev)
    layout = MT.prepare_refine(level0, part, MultilevelFAParams())
    coords_A = project_to_levels(main_coords, res.levels[:1])[1]
    r_A = torch.full((part.num_aggs,), 0.05, device=dev)
    torch.cuda.synchronize()
    metrics = MetricsLogger()
    with profiling.trace(TRACE_DIR) as prof:
        with metrics.span("linlog flat step", dev):
            x = drive_steps(torch, tfa, params, dev, FLAT_ITERS)
        with metrics.span("level-0 slot-space refine", dev):
            y = MT.refine_level_tiled(level0, part, coords_A, r_A, 3,
                                      iterations=REFINE_ITERATIONS,
                                      layout=layout)
        torch.cuda.synchronize()
    require(bool(torch.isfinite(x).all()) and bool(torch.isfinite(y).all()),
            "profiled paths: finite coordinates")
    found = profiled_kernels(prof)
    rows = []
    for kernel, (calls, ms) in found.items():
        require(calls > 0 and ms > 0, f"the trace names {kernel} with CUDA "
                "time")
        rows.append(dict(kernel=kernel, calls=calls, cuda_ms=ms,
                         cuda_ms_per_call=ms / calls,
                         device_ms=kernels[kernel]["ms"]))
    trace = os.path.join(TRACE_DIR, "trace.json")
    emit(phase="profile", paths=[f"rmat(20,8) linlog x{FLAT_ITERS}",
                                 f"mesh3d({MESH_SIDE}) level-0 refine x"
                                 f"{REFINE_ITERATIONS}"],
         kernels=rows, trace=os.path.relpath(trace, ROOT),
         trace_bytes=os.path.getsize(trace),
         seconds=time.perf_counter() - t0)


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


def hierarchies_equal(torch, a, b) -> bool:
    return a.level_sizes == b.level_sizes and all(
        torch.equal(x.vertex_to_agg.to(y.device), y.vertex_to_agg)
        for x, y in zip(a.levels, b.levels))


def first_divergence(torch, a, b):
    """The first level at which two hierarchies differ, with the number of
    vertices whose aggregate differs there."""
    for lvl, (x, y) in enumerate(zip(a.levels, b.levels)):
        if x.num_aggs != y.num_aggs or not torch.equal(
                x.vertex_to_agg.to(y.device), y.vertex_to_agg):
            diff = (int((x.vertex_to_agg.cpu() != y.vertex_to_agg.cpu()).sum())
                    if x.n == y.n else None)
            return {"level": lvl, "aggs": [x.num_aggs, y.num_aggs],
                    "vertices_differing": diff}
    return {"level": min(len(a.levels), len(b.levels)),
            "sizes": [a.level_sizes, b.level_sizes]}


def phase_device_partition(torch, g, res, native_s: float, flat: dict, dev,
                           main_coords) -> None:
    """The device coarsener at full width.  mesh3d(128) on the card with
    its host COO dropped: ``auto`` must pick the device backend, and the
    hierarchy must equal the setup's native one level by level
    (torch.equal), the device Galerkin chain the native emitted chain
    (indptr, indices and weights torch.equal: unit-weight sums are
    integers below 2^24).  The same on the flat phase's unit-weight
    rmat(20, 8), whose hubs take absorb rounds.  Then embed_graph on the
    card-only mesh3d(128): the device coarsener, build_galerkin_chain, the
    embed; its layout stress within 1% of the main phase's.  Each path is
    driven with the launch counts set to 0 just before it."""
    import dataclasses

    import graph_embed_tpu_torch as gp
    from graph_embed_tpu_torch.harness.runtests import layout_stress
    from graph_embed_tpu_torch.ops import cuda
    from graph_embed_tpu_torch.partition import hierarchy as H

    gd = dataclasses.replace(g.to(dev), host_coo=None)
    require(H._pick_backend("auto", gd) == "device",
            "auto picks the device coarsener for a card-only graph")
    cuda.LAUNCHES.clear()
    t0 = time.perf_counter()
    resd = gp.partition_hierarchy(gd, 0.1)
    torch.cuda.synchronize()
    dev_s = time.perf_counter() - t0
    launches = dict(cuda.LAUNCHES)
    require(launches.get("edge_spmm[unit]", 0) > 0,
            "kernel A launched by the device coarsener")
    require(hierarchies_equal(torch, resd, res),
            f"device hierarchy of mesh3d({MESH_SIDE}) equals the native one "
            f"({first_divergence(torch, resd, res)})")
    cuda.LAUNCHES.clear()
    t0 = time.perf_counter()
    chain = gp.build_galerkin_chain(gd, resd.levels, backend="device")
    torch.cuda.synchronize()
    chain_s = time.perf_counter() - t0
    chain_launches = dict(cuda.LAUNCHES)
    require(chain_launches.get("edge_spmm[unit]", 0) > 0,
            "kernel A launched by the device Galerkin chain")
    for lvl, (a, b) in enumerate(zip(chain[1:], res.coarse_graphs)):
        b = b.to(dev)
        require(torch.equal(a.indptr, b.indptr)
                and torch.equal(a.receivers, b.receivers)
                and torch.equal(a.weights, b.weights),
                f"device Galerkin level {lvl + 1} equals the native chain")
    emit(phase="device partition", graph=f"mesh3d({MESH_SIDE})",
         level_sizes=resd.level_sizes, device_hierarchy_seconds=dev_s,
         device_chain_seconds=chain_s, native_hierarchy_seconds=native_s,
         device_Q=resd.modularity, native_Q=res.modularity,
         launches=launches, chain_launches=chain_launches, equal=True)
    del chain

    rmat = flat["rmat(20,8)"][0]
    rhost = rmat.to("cpu")
    t0 = time.perf_counter()
    rn = gp.partition_hierarchy(rhost, 0.1)
    rn_s = time.perf_counter() - t0
    cuda.LAUNCHES.clear()
    t0 = time.perf_counter()
    rd = gp.partition_hierarchy(dataclasses.replace(rmat, host_coo=None),
                                0.1)
    torch.cuda.synchronize()
    rd_s = time.perf_counter() - t0
    rlaunches = dict(cuda.LAUNCHES)
    same = hierarchies_equal(torch, rd, rn)
    emit(phase="device partition", graph="rmat(20, 8, seed=1) unit weights",
         n=rmat.n, stored_entries=rmat.num_edges,
         level_sizes=rd.level_sizes, native_level_sizes=rn.level_sizes,
         device_hierarchy_seconds=rd_s, native_hierarchy_seconds=rn_s,
         device_Q=rd.modularity, native_Q=rn.modularity, launches=rlaunches,
         equal=same, divergence=None if same else first_divergence(
             torch, rd, rn))
    require(same, "device hierarchy of rmat(20, 8) equals the native one")

    metrics = gp.MetricsLogger()
    cuda.LAUNCHES.clear()
    t0 = time.perf_counter()
    coords, eres = gp.embed_graph(gd, 3, device=dev, coarsening_factor=0.1,
                                  metrics=metrics)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    elaunches = dict(cuda.LAUNCHES)
    for name in ("edge_spmm[unit]", "edge_spmm[weighted]",
                 "bucket_repulsion"):
        require(elaunches.get(name, 0) > 0,
                f"{name} launched by the card-only embed")
    require(tuple(coords.shape) == (g.n, 3)
            and bool(torch.isfinite(coords).all()),
            "card-only embed: finite [n, 3]")
    stress = layout_stress(g, coords)
    main_stress = layout_stress(g, main_coords)
    emit(phase="device partition", path="embed_graph card-only "
         f"mesh3d({MESH_SIDE})", seconds=wall, level_sizes=eres.level_sizes,
         spans=[{k: v for k, v in r.items() if k != "launches"}
                for r in metrics.records],
         launches=elaunches, layout_stress=stress,
         main_layout_stress=main_stress,
         coords_equal_main=bool(torch.equal(coords, main_coords)))
    require(abs(stress - main_stress) <= 0.01 * main_stress,
            "card-only embed's stress within 1% of the main embed's")


def modularity_f64(s, r, w, v2a) -> float:
    """Q = sum_A (d_A/T - alpha_A^2) in float64 numpy
    (src/partitioner.cpp:69-114)."""
    import numpy as np

    w = np.asarray(w, np.float64)
    a, b = v2a[s], v2a[r]
    m = int(v2a.max()) + 1
    intra = a == b
    d = np.bincount(a, weights=np.where(intra, w, 0.0), minlength=m)
    tot = np.bincount(a, weights=w, minlength=m)
    T = w.sum()
    return float((d / T - (tot / T) ** 2).sum())


def launches_of(stderr: str) -> dict:
    lines = [ln for ln in stderr.splitlines()
             if ln.startswith("kernel launches: ")]
    require(len(lines) == 1, "the CLI reports its kernel launches")
    return json.loads(lines[0][len("kernel launches: "):])


RUN_TESTS_SPEC = "synth:planted:200:500:0.05:0.0001"


def phase_run_tests(dev) -> None:
    """``cli run-tests`` on the planted graph (100,000 vertices, 3.43M
    stored entries) with -communities -heuristics on the card: one record;
    its modularity and variant_modularity within 1e-5 of float64 numpy on
    the same partitions (partition_base and partition_test are
    deterministic host code, rerun here)."""
    import graph_embed_tpu_torch as gp
    from graph_embed_tpu_torch.graph import synth

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "graph_embed_tpu_torch.cli", "run-tests",
         RUN_TESTS_SPEC, "-communities", "-heuristics", "-device", str(dev)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    require(proc.returncode == 0, "cli run-tests exits 0: "
            + proc.stderr[-2000:])
    records = [json.loads(ln) for ln in proc.stdout.splitlines()
               if ln.startswith("{")]
    require(len(records) == 1, "cli run-tests prints one record")
    rec = records[0]
    launches = launches_of(proc.stderr)
    require(launches.get("edge_spmm[unit]", 0) > 0,
            "run-tests' modularity evaluations launch kernel A")
    args = RUN_TESTS_SPEC.split(":")[2:]
    g, _ = synth.planted_partition(int(args[0]), int(args[1]),
                                   p_in=float(args[2]), p_out=float(args[3]))
    s, r, w = g.to_coo_numpy()
    q = {}
    for key, part in (("modularity", gp.partition_base(g, 0.999)),
                      ("variant_modularity", gp.partition_test(g, 0.999))):
        q[key] = modularity_f64(s, r, w, part.vertex_to_agg_numpy())
        require(abs(rec[key] - q[key]) <= 1e-5,
                f"run-tests {key} {rec[key]} within 1e-5 of float64 "
                f"{q[key]}")
    emit(phase="run-tests", graph=RUN_TESTS_SPEC, n=rec["n"],
         stored_entries=rec["edges"], seconds=wall,
         partition_seconds=rec["partition_seconds"],
         variant_seconds=rec["variant_seconds"],
         aggregates=rec["aggregates"], modularity=rec["modularity"],
         modularity_f64=q["modularity"],
         variant_modularity=rec["variant_modularity"],
         variant_modularity_f64=q["variant_modularity"],
         ground_truth=rec.get("ground_truth_similarity"), launches=launches)


def run_embedder(src: str, out: str, plot: bool, dev):
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "graph_embed_tpu_torch.cli", "embedder",
         "-f", src, "-outdir", out, "-plot", "true" if plot else "false",
         "-device", str(dev)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    require(proc.returncode == 0, "cli embedder exits 0: "
            + proc.stderr[-2000:])
    lines = proc.stdout.splitlines()
    require(any("(native parser)" in ln for ln in lines),
            "the embedder read its file with the native parser")

    def seconds(prefix):
        ln = [x for x in lines if x.startswith(prefix)][0]
        return float(ln.split("in time ")[1].split("s")[0])

    sizes = [int(x) for x in
             lines[lines.index([x for x in lines
                                if x.startswith("partitioned!")][0]) + 1]
             .split()]
    times = {k: seconds(p) for k, p in (
        ("read_seconds", "read in"), ("partition_seconds", "partitioned!"),
        ("embed_seconds", "embedded!"), ("write_seconds", "written"))}
    return wall, sizes, times, launches_of(proc.stderr)


def phase_embedder(g, dev) -> None:
    """``cli embedder`` on mesh3d(128)'s upper-triangle pairs as an
    adjlist (-plot false): exit 0, the native parser, coords.temp with one
    finite row per vertex, a part.temp that reads back to the printed level
    sizes; then on the cli phase's ring of cliques with -plot true, a
    plot.html whose embedded JSON has one point per vertex."""
    import numpy as np

    from graph_embed_tpu_torch.viz import _read_multilevel_partition

    work = os.path.join(ROOT, "graph_embed_tpu_torch", "_build", "smoke")
    os.makedirs(work, exist_ok=True)
    s, r, _ = g.to_coo_numpy()
    up = s < r
    src = os.path.join(work, "mesh.adjlist")
    t0 = time.perf_counter()
    with open(src, "w") as f:
        f.writelines(map("{} {}\n".format, s[up].tolist(), r[up].tolist()))
    write_s = time.perf_counter() - t0
    out = os.path.join(work, "embedder_mesh")
    wall, sizes, times, launches = run_embedder(src, out, False, dev)
    for name in ("edge_spmm[unit]", "edge_spmm[weighted]",
                 "bucket_repulsion"):
        require(launches.get(name, 0) > 0, f"{name} launched by embedder")
    require(sizes[0] == g.n, "embedder keeps the whole connected mesh")
    with open(os.path.join(out, "coords.temp")) as f:
        coords = np.array(f.read().split(), dtype=np.float64)
    require(coords.size == 3 * g.n and bool(np.isfinite(coords).all()),
            f"coords.temp holds {g.n} finite rows of 3")
    t0 = time.perf_counter()
    back = _read_multilevel_partition(os.path.join(out, "part.temp"))
    read_part_s = time.perf_counter() - t0
    require([len(a) for a in back] == sizes[:-1]
            and [int(a.max()) + 1 for a in back] == sizes[1:],
            "part.temp reads back to the printed level sizes")
    emit(phase="embedder", graph=f"mesh3d({MESH_SIDE})", n=g.n,
         adjlist_lines=int(up.sum()), adjlist_write_seconds=write_s,
         seconds=wall, level_sizes=sizes, part_read_seconds=read_part_s,
         launches=launches, **times)

    ring = os.path.join(work, "ring.txt")
    out = os.path.join(work, "embedder_ring")
    wall, sizes, times, launches = run_embedder(ring, out, True, dev)
    with open(os.path.join(out, "plot.html")) as f:
        html = f.read()
    verts = json.loads(html.split("const V=")[1].split(", E=")[0])
    require(len(verts) == sizes[0], "plot.html has one point per vertex")
    emit(phase="embedder", graph="ring of cliques (cli phase)", n=sizes[0],
         seconds=wall, level_sizes=sizes, plot_points=len(verts),
         launches=launches, **times)


def stop_group(proc) -> None:
    """Kill ``proc``'s process group (a driver and its workers)."""
    import signal

    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def start_script(argv: list, timeout: int, name: str | None = None) -> dict:
    """Start ``python argv`` from the checkout in its own process group,
    stopped at exit if it is still running.  Its standard output and error
    go to files under SCRIPT_LOGS (a pipe nobody reads while it runs could
    stall it).  ``timeout`` counts from now; ``name`` (the script's file
    name by default) labels its checks."""
    import atexit

    name = name or os.path.basename(argv[0])
    os.makedirs(SCRIPT_LOGS, exist_ok=True)
    stem = os.path.join(SCRIPT_LOGS, f"{next(_SCRIPT_RUNS):02d}_"
                        + name.replace("/", "_"))
    with open(stem + ".out", "w") as out, open(stem + ".err", "w") as err:
        proc = subprocess.Popen([sys.executable, *argv], cwd=ROOT,
                                stdout=out, stderr=err,
                                start_new_session=True)
    atexit.register(stop_group, proc)
    return dict(name=name, proc=proc, stem=stem, timeout=timeout,
                t0=time.perf_counter())


def wait_script(run: dict) -> dict:
    """Wait for a ``start_script`` run until its timeout (then kill it);
    the run with ``rc`` (None past the timeout), ``out``, ``err`` and
    ``seconds``."""
    left = run["t0"] + run["timeout"] - time.perf_counter()
    try:
        rc = run["proc"].wait(timeout=max(left, 0.0))
    except subprocess.TimeoutExpired:
        stop_group(run["proc"])
        rc = None
    texts = {}
    for ext in ("out", "err"):
        with open(f"{run['stem']}.{ext}") as f:
            texts[ext] = f.read()
    return dict(run, rc=rc, seconds=time.perf_counter() - run["t0"],
                **texts)


def script_ok(done: dict) -> tuple:
    """Require that a finished run exited 0 in time; (stdout, stderr,
    seconds)."""
    name = done["name"]
    require(done["rc"] is not None,
            f"{name} finishes within {done['timeout']} s")
    require(done["rc"] == 0, f"{name} exits 0: {done['err'][-3000:]}")
    return done["out"], done["err"], done["seconds"]


def run_script(argv: list, timeout: int = AT_SCALE_TIMEOUT,
               name: str | None = None) -> tuple:
    return script_ok(wait_script(start_script(argv, timeout, name)))


def run_in_turn(runs: list):
    """Run the scripts ``runs`` ([argv]) one after another in a thread,
    stopping at the first that fails; (thread, {name: finished run})."""
    import threading

    results = {}

    def body():
        for argv in runs:
            done = wait_script(start_script(argv, AT_SCALE_TIMEOUT))
            results[done["name"]] = done
            if done["rc"] != 0:
                return

    thread = threading.Thread(target=body, daemon=True)
    thread.start()
    return thread, results


def start_lj_prep() -> dict:
    """Start the LJ-scale pipeline's prep stage (generation and native
    partition: host work only) in the background from an empty cache, so
    it overlaps the phases before ``phase_lj_scale``; stopped at exit."""
    import shutil

    shutil.rmtree(LJ_SCALE_CACHE, ignore_errors=True)
    return start_script(["scripts/lj_scale_run_torch.py", "prep",
                         *LJ_SCALE], LJ_SCALE_TIMEOUT, name="lj scale prep")


def json_lines(text: str) -> list:
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def check_embed_lines(lines: list, label: str, refined: list,
                      stress_want: float) -> dict:
    """The checks an embed driver's lines (scripts/lj_scale_run_torch.py,
    one arm of scripts/halo_pipeline_run_torch.py) must pass: kernels A and
    B launched in the refine spans, every level in ``refined`` finite
    inside its parent balls within their slack, and the layout stress
    within LJ_SCALE_STRESS_GAP of the JAX record's ``stress_want``.
    Returns the lines by phase, the launches summed per span name, the
    balls and the stress."""
    by = {}
    for ln in lines:
        if "phase" in ln:
            by.setdefault(ln["phase"], []).append(ln)
    launched = {}
    for sp in by["span"]:
        per = launched.setdefault(sp["span"], {})
        for k, v in sp["launches"].items():
            per[k] = per.get(k, 0) + v
    refine = launched.get("refine", {})
    require(sum(v for k, v in refine.items() if k.startswith("edge_spmm["))
            > 0 and refine.get("bucket_repulsion", 0) > 0,
            f"{label}: kernels A and B launched in the refine spans "
            f"({refine})")
    balls = by["balls"][0]["levels"]
    require(sorted(balls) == sorted(str(l) for l in refined),
            f"{label}: levels {refined} checked against their parent balls")
    for level, b in balls.items():
        require(b["finite"] and b["excess"] <= b["slack"],
                f"{label}: level {level} finite inside its parent balls "
                f"({b})")
    stress = by["stress"][0]["stress"]
    require(abs(stress - stress_want) <= LJ_SCALE_STRESS_GAP * stress_want,
            f"{label}: layout stress {stress} within "
            f"{LJ_SCALE_STRESS_GAP:.0%} of the JAX record's {stress_want}")
    return dict(by=by, launched=launched, balls=balls, stress=stress)


def at_scale_out(name: str) -> str:
    """A fresh path under AT_SCALE_DIR for a driver's ``--out``."""
    os.makedirs(AT_SCALE_DIR, exist_ok=True)
    path = os.path.join(AT_SCALE_DIR, name)
    if os.path.exists(path):
        os.remove(path)
    return path


def start_pipeline(prep: dict, dev) -> tuple:
    """Once the background prep has cached the LJ-scale graph and its
    hierarchy (required to have exited 0), start the halo pipeline on that
    cache: it is host-bound (its top-level radii sweeps and its plans), so
    it runs beside the lj scale, drivers and drivers at scale phases, and
    ``phase_drivers_at_scale`` checks it.  (the run, seconds waited for the
    prep)."""
    t0 = time.perf_counter()
    script_ok(wait_script(prep))
    prep_wait = time.perf_counter() - t0
    pipe = start_script(["scripts/halo_pipeline_run_torch.py", *PIPE_ARGS,
                         "--device", str(dev), "--out",
                         at_scale_out("halo_pipeline.jsonl")],
                        AT_SCALE_TIMEOUT)
    return pipe, prep_wait


def phase_lj_scale(torch, dev, smi: str, prep_wait: float) -> dict:
    """The power-law pipeline at LiveJournal scale through its driver:
    ``scripts/lj_scale_run_torch.py all 22 8`` in a subprocess, on the
    background prep's cache (``prep_wait``: the seconds the script waited
    for it).  The hierarchy
    must be the JAX record's (levels, entries, Q), level 0's refinement
    must hold sampled buckets, and the embed must pass
    ``check_embed_lines`` on every refined level.  Then kernels A and B
    are held against their plain versions at the pipeline's shapes
    (``lj_scale_holds``, whose worst errors it returns)."""
    out, _, wall = run_script(["scripts/lj_scale_run_torch.py", "all",
                               *LJ_SCALE], LJ_SCALE_TIMEOUT)
    lines = json_lines(out)
    rec = lines[-1]
    require(rec["n"] == LJ_SCALE_LEVELS[0]
            and rec["level_sizes"] == LJ_SCALE_LEVELS,
            f"rmat(22, 8) levels {rec['level_sizes']}")
    require(rec["level_edges"] == LJ_SCALE_ENTRIES,
            f"rmat(22, 8) level entries {rec['level_edges']}")
    require(abs(rec["modularity"] - LJ_SCALE_Q) <= 1e-4,
            f"rmat(22, 8) Q {rec['modularity']}")
    checked = check_embed_lines(lines, "lj scale",
                                list(range(len(LJ_SCALE_LEVELS) - 1)),
                                LJ_SCALE_STRESS)
    by = checked["by"]
    buckets = {b["level"]: b for b in by["buckets"]}
    require(len(buckets[0]["sampled"]) > 0,
            "level 0's refinement holds sampled buckets")
    require(rec["coords_finite"] is True, "finite coordinates")
    memory = by["memory"][0]
    emit(phase="lj scale", nvidia_smi=smi, workload=rec["workload"],
         n=rec["n"], level_sizes=rec["level_sizes"],
         level_entries=rec["level_edges"], modularity=rec["modularity"],
         base_iterations=rec["base_iterations"],
         gen_seconds=rec["gen_seconds"],
         partition_seconds=rec["partition_seconds"],
         galerkin_seconds=rec["galerkin_seconds"],
         prep_wait_seconds=prep_wait, embed_seconds=rec["embed_seconds"],
         stress_seconds=rec["stress_seconds"], run_seconds=wall,
         spans=[{k: v for k, v in sp.items() if k != "phase"}
                for sp in by["span"]],
         buckets=by["buckets"], ball_excess=checked["balls"],
         max_memory_allocated=memory["max_memory_allocated"],
         launches=memory["launches"],
         refine_launches=checked["launched"].get("refine", {}),
         layout_stress=checked["stress"], jax_record_stress=LJ_SCALE_STRESS)
    return lj_scale_holds(torch, dev)


def lj_scale_holds(torch, dev) -> dict:
    """Kernels A and B against their plain versions at the LJ-scale
    pipeline's shapes, on the cache its run left: kernel A on level 0's
    slot CSR (unit) and its sender CSR (the cut-edge pull), both with hub
    rows, and on level 1's slot CSR (weighted); kernel B on every exact
    size class of levels 0 and 1.  Returns each kernel's worst
    (max_abs_err, max_err_over_scale) for the summary line."""
    import dataclasses

    from graph_embed_tpu_torch.forceatlas import multilevel_tiled as MT
    from graph_embed_tpu_torch.ops import edge_spmm as ES
    from graph_embed_tpu_torch.utils.params import MultilevelFAParams

    t0 = time.perf_counter()
    graphs, parts, _ = load_script("lj_scale_run_torch").load_cache(
        *map(int, LJ_SCALE))
    params = MultilevelFAParams()
    gen = torch.Generator(device=dev).manual_seed(11)
    worst = {}

    def held(kernel, err_ratio):
        prev = worst.get(kernel, (0.0, 0.0))
        worst[kernel] = (max(err_ratio[0], prev[0]),
                         max(err_ratio[1], prev[1]))

    def hold_a(csr, x, **fields):
        abs_csr = (csr if csr.w is None
                   else dataclasses.replace(csr, w=csr.w.abs()))
        got = ES.spmv_cuda(x, csr)
        want = ES.spmv_plain(x, csr)
        scale = ES.spmv_plain(x.abs(), abs_csr)
        torch.cuda.synchronize()
        name = f"edge_spmm[{csr.kind}]"
        held(name, hold(name, got, want, scale, path="lj scale",
                        rows=csr.n_rows, nnz=csr.nnz,
                        hub_rows=int(csr.hub_rows.numel()), **fields))

    for level in (0, 1):
        g, part = graphs[level].to(dev), parts[level].to(dev)
        layout = MT.prepare_refine(g, part, params)
        x = torch.rand((layout.n_slots, 3), generator=gen, device=dev) * 2 - 1
        x = torch.where(layout.valid_slot[:, None], x, torch.zeros_like(x))
        hold_a(layout.csr, x, level=level, table="slot CSR")
        if level == 0:
            xs = (torch.rand((layout.sender_csr.n_cols, 3), generator=gen,
                             device=dev) * 2 - 1)
            hold_a(layout.sender_csr, xs, level=level,
                   table="sender (cut-edge pull)")
        got = MT.exact_repulsion_cuda(x, layout, params.repel,
                                      params.epsilon)
        want = MT.exact_repulsion_plain(x, layout, params.repel,
                                        params.epsilon)
        scale = MT.exact_repulsion_plain(x, layout, params.repel,
                                         params.epsilon, absolute=True)
        torch.cuda.synchronize()
        for b in layout.buckets:
            if not b.sampled:
                sl = b.slots
                held("bucket_repulsion", hold(
                    "bucket_repulsion", got[sl], want[sl], scale[sl],
                    path="lj scale", level=level, S=b.S, aggregates=b.m_b))
        del g, part, layout, x, got, want, scale
    emit(phase="lj scale holds", seconds=time.perf_counter() - t0,
         worst={k: list(v) for k, v in worst.items()})
    return worst


def phase_drivers(dev) -> None:
    """``examples/staged_configs_torch.py`` 1-4 and
    ``examples/quickstart_torch.py`` on the card, each in a subprocess:
    exit 0 and ``finite`` in its record; config 3 must launch kernel D
    (its tiled step), every run some kernel of the port."""
    work = os.path.join(ROOT, "graph_embed_tpu_torch", "_build", "smoke")
    os.makedirs(work, exist_ok=True)
    runs = [(f"staged config {k}", ["examples/staged_configs_torch.py",
                                    str(k)]) for k in (1, 2, 3, 4)]
    runs.append(("quickstart", ["examples/quickstart_torch.py",
                                os.path.join(work, "quickstart.html")]))
    for name, argv in runs:
        out, err, wall = run_script([*argv, "--device", str(dev)],
                                    DRIVER_TIMEOUT, name=name)
        rec = json_lines(out)[-1]
        launches = launches_of(err)
        require(rec["finite"] is True, f"{name}: finite coordinates")
        require(sum(launches.values()) > 0, f"{name} launched kernels")
        if name == "staged config 3":
            require(launches.get("fused_step", 0) > 0,
                    "config 3 runs the tiled step (kernel D)")
        emit(phase="drivers", run=name, record=rec, launches=launches,
             seconds=wall)


def first_records(path: str, k: int) -> list:
    with open(path) as f:
        return [json.loads(ln) for ln in f.read().splitlines()[:k]]


def phase_drivers_at_scale(torch, dev, smi: str, pipe: dict) -> dict:
    """The halo pipeline (``pipe``, started by ``start_pipeline``), the
    halo and LJ step probes, the two-process record and the quality tools
    through their drivers, each in a subprocess, on the LJ-scale cache;
    each record held to the JAX record of the same host facts.  While the
    pipeline runs, the two-process record and the quality tools run in
    turn beside it, and the kernel holds at its and the probes' shapes
    (``pipeline_holds``, whose worst errors it returns) here; the two step
    probes, whose times are CUDA events of a few milliseconds, run after
    them, alone."""
    import numpy as np

    dev_args = ("--device", str(dev))
    beside, results = run_in_turn([
        ["scripts/dist_halo_record_torch.py", DIST_SCALE, *dev_args,
         "--out", at_scale_out("dist_halo_record.jsonl")],
        ["scripts/quality_roster_torch.py", *ROSTER_ARGS, *dev_args, "-o",
         at_scale_out("bench_quality.jsonl")],
        ["scripts/planted_precision_torch.py", "--caps", PLANTED_CAPS,
         *dev_args, "-o", at_scale_out("bench_planted_precision.jsonl")]])
    worst = pipeline_holds(torch, dev)

    # the halo pipeline: both arms at full size
    out, err, wall = script_ok(wait_script(pipe))
    lines = json_lines(out)
    rec = lines[-1]
    require(rec["level_sizes"] == PIPE_LEVELS
            and rec["level_edges"] == PIPE_ENTRIES,
            f"the pipeline keeps levels {rec['level_sizes']} with entries "
            f"{rec['level_edges']}")
    arms = {}
    for arm in ("halo", "replicated"):
        a = rec[arm]
        checked = check_embed_lines(
            [ln for ln in lines if ln.get("arm") == arm], f"{arm} arm",
            [0], PIPE_STRESS)
        by = checked["by"]
        require(checked["launched"].get("base", {}).get(
            "edge_spmm[weighted]", 0) > 0,
            f"{arm} arm: kernel A weighted in the base span")
        for sp in by["span"]:
            require(0 <= sp["device_seconds"]
                    <= sp["seconds"] * (1 + BUSY_SLACK),
                    f"{arm} arm: the card busy inside the {sp['span']} "
                    f"span no longer than the span ({sp})")
        require(a["coords_finite"] is True, f"{arm} arm: finite coordinates")
        require(a["base_repulsion"] == "sampled",
                f"{arm} arm: the base case on the sampled estimator")
        peak = by["memory"][0]["max_memory_allocated"]
        require(peak < PIPE_DENSE_BYTES,
                f"{arm} arm: peak memory {peak} below the dense gram "
                f"block's {PIPE_DENSE_BYTES} bytes")
        arms[arm] = dict(
            embed_seconds=a["embed_seconds"], stress=checked["stress"],
            stress_seconds=a["stress_seconds"],
            base_repulsion=a["base_repulsion"],
            spans=[{k: v for k, v in sp.items() if k not in ("phase", "arm")}
                   for sp in by["span"]],
            buckets=[{k: v for k, v in b.items() if k not in ("phase", "arm")}
                     for b in by["buckets"]],
            ball_excess=checked["balls"], max_memory_allocated=peak)
    emit(phase="drivers at scale", run="halo pipeline", nvidia_smi=smi,
         args=list(PIPE_ARGS), level_sizes=rec["level_sizes"],
         level_entries=rec["level_edges"],
         halo_vs_replicated_embed=rec["halo_vs_replicated_embed"],
         jax_record_stress=PIPE_STRESS, dense_gram_bytes=PIPE_DENSE_BYTES,
         seconds=wall, **arms)

    # two processes of 4 shards against one of 8
    beside.join(timeout=3 * AT_SCALE_TIMEOUT)
    for name in ("dist_halo_record_torch.py", "quality_roster_torch.py",
                 "planted_precision_torch.py"):
        require(name in results, f"{name} ran")
    out, _, wall = script_ok(results["dist_halo_record_torch.py"])
    lines = json_lines(out)
    recs = [ln for ln in lines if "workload" in ln]
    want = first_records(DIST_RECORD, 1)[0]
    require([(r["nprocs"], r["ndev_local"]) for r in recs] == [(1, 8),
                                                               (2, 4)],
            "both arms of the two-process record ran")
    for r in recs:
        require((r["n"], r["edges"], r["levels"]) == (
            want["n"], want["edges"], want["levels"]),
            f"rmat({DIST_SCALE}, 8): n, edges and levels of the JAX record")
        require(r["comm_model"] == want["comm_model"],
                f"the comm model {r['comm_model']} is the JAX record's")
        require(r["launches"].get("edge_spmm[weighted]", 0) > 0
                and r["launches"].get("bucket_repulsion", 0) > 0,
                f"the {r['nprocs']}-process embed runs kernels A and B")
    require(lines[-1]["checksums_equal"] is True
            and recs[0]["coords_checksum"] == recs[1]["coords_checksum"],
            "2 x 4 shards give the coordinates of 1 x 8")
    emit(phase="drivers at scale", run="two-process record", nvidia_smi=smi,
         records=recs, seconds=wall)

    # the quality roster's planted 100k entry, with its embed
    out, err, wall = script_ok(results["quality_roster_torch.py"])
    rec = json_lines(out)[-1]
    want = first_records(ROSTER_RECORD, 1)[0]
    require(rec["graph"] == want["graph"] and "error" not in rec,
            f"the roster ran {want['graph']}")
    for key in ("n", "edges", "aggregates", "level_sizes",
                "ground_truth_similarity"):
        require(rec[key] == want[key], f"roster {key}: {rec[key]} against "
                f"the JAX record's {want[key]}")
    for key in ("modularity", "variant_modularity"):
        require(abs(rec[key] - want[key]) <= 1e-4, f"roster {key}")
    require(np.allclose(rec["level_modularity"], want["level_modularity"],
                        rtol=0, atol=1e-4), "roster level modularity")
    require(0 < rec["stress"] < float("inf"), "the roster's embed is finite")
    launches = launches_of(err)
    require(launches.get("bucket_repulsion", 0) > 0,
            "the roster's embed runs kernel B")
    emit(phase="drivers at scale", run="quality roster", nvidia_smi=smi,
         record=rec, launches=launches, seconds=wall)

    # the planted 1M graph, uncapped and capped at 1,200
    out, err, wall = script_ok(results["planted_precision_torch.py"])
    recs = json_lines(out)
    wants = first_records(PLANTED_RECORD, 2)
    require(len(recs) == 2, "one record per cap")
    for r, w in zip(recs, wants):
        for key in ("graph", "max_agg_size", "level_sizes", "truth_level",
                    "similarity"):
            require(r[key] == w[key], f"planted cap {w['max_agg_size']} "
                    f"{key}: {r[key]} against the JAX record's {w[key]}")
        require(abs(r["Q_at_level"] - w["Q_at_level"]) <= 1e-4,
                f"planted cap {w['max_agg_size']} Q")
    launches = launches_of(err)
    require(sum(v for k, v in launches.items()
                if k.startswith("edge_spmm[")) > 0,
            f"the planted modularities run kernel A ({launches})")
    emit(phase="drivers at scale", run="planted precision", nvidia_smi=smi,
         records=recs, launches=launches, seconds=wall)

    # alone: the halo and flat steps at one shard on the ordered rmat(22, 8)
    out, _, wall = run_script(["scripts/halo_scale_run_torch.py", *LJ_SCALE,
                               *dev_args, "--out",
                               at_scale_out("halo_scale.jsonl")])
    rec = json_lines(out)[-1]
    require(abs(rec["plan8_boundary_fraction"] - PLAN8_BOUNDARY_FRACTION)
            <= PLAN8_GAP, f"the 8-shard plan's boundary fraction "
            f"{rec['plan8_boundary_fraction']}")
    for key in ("halo_ms_per_iter", "replicated_ms_per_iter"):
        require(rec[key] > 0 and rec[key] < float("inf"), f"{key} finite")
    require(rec["halo_launches"].get("edge_spmm[unit]", 0) > 0
            and rec["replicated_launches"].get("fused_step", 0) > 0,
            "the halo step runs kernel A, the flat step kernel D")
    emit(phase="drivers at scale", run="halo scale", nvidia_smi=smi,
         record=rec, seconds=wall)

    # the full flat step, the JAX probe's default shape
    out, _, wall = run_script(["scripts/lj_step_probe_torch.py", *LJ_SCALE,
                               *dev_args, "--out",
                               at_scale_out("BENCH_LJ_torch.jsonl")])
    rec = json_lines(out)[-1]
    require((rec["n"], rec["edges"]) == (LJ_SCALE_LEVELS[0],
                                         LJ_SCALE_ENTRIES[0]),
            f"the probe's graph n={rec['n']} edges={rec['edges']}")
    require(0 < rec["ms_per_iter"] < float("inf"), "the probe's ms finite")
    require(rec["launches"].get("fused_step", 0) > 0,
            "the probe's step runs kernel D")
    emit(phase="drivers at scale", run="lj step probe", nvidia_smi=smi,
         record=rec, seconds=wall)
    return worst


def load_script(name: str):
    """``scripts/<name>.py`` as a module (the drivers' own helpers)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def pipeline_holds(torch, dev) -> dict:
    """Kernels against their plain versions at the shapes of the drivers
    at scale: kernel A on the halo base case's CSR (level 1 of the
    LJ-scale cache in the order of the dropped levels, one shard, its
    Galerkin weights folded and truncated to bf16: the weighted mode); and
    on the probes' plan (``prepare_tiled`` on level 0 in hierarchy order
    with unit weights, as scripts/lj_step_probe_torch.py builds it, at its
    default shape) kernel A unit on the residual edges and kernel D on the
    whole step.  Returns each kernel's worst (max_abs_err,
    max_err_over_scale)."""
    import dataclasses

    import graph_embed_tpu_torch as gp
    from graph_embed_tpu_torch.forceatlas import tiled as TL
    from graph_embed_tpu_torch.ops import edge_spmm as ES
    from graph_embed_tpu_torch.parallel import halo as PH

    t0 = time.perf_counter()
    graphs, parts, _ = load_script("lj_scale_run_torch").load_cache(
        *map(int, LJ_SCALE))
    order = gp.partition_order(graphs[1], levels=parts[1:])
    g_ord, _ = gp.apply_order(graphs[1], order)
    plan = PH.build_halo_plan(g_ord, 1)
    csr = PH.build_halo_csr(plan, gp.ForceAtlasParams(repulsion="sampled"),
                            device=dev).csr
    require(csr.w is not None, "the base case's halo CSR is weighted")
    gen = torch.Generator(device=dev).manual_seed(13)
    x = torch.rand((csr.n_cols, 3), generator=gen, device=dev) * 2 - 1
    got = ES.spmv_cuda(x, csr)
    want = ES.spmv_plain(x, csr)
    scale = ES.spmv_plain(x.abs(), dataclasses.replace(csr, w=csr.w.abs()))
    torch.cuda.synchronize()
    name = f"edge_spmm[{csr.kind}]"
    worst = {name: hold(name, got, want, scale, path="drivers at scale",
                        table="halo base case CSR", rows=csr.n_rows,
                        nnz=csr.nnz, hub_rows=int(csr.hub_rows.numel()))}
    del graphs, parts, g_ord, plan, csr, x, got, want, scale

    probe = load_script("lj_step_probe_torch")
    g, workload = probe.probe_graph(*map(int, LJ_SCALE))
    g = g.to(dev)
    params = flat_params()
    tfa = TL.prepare_tiled(g, 3, params, sender_block=PROBE_SHAPE,
                           window=PROBE_SHAPE, tile=1024, min_pair_edges=0)
    require(tfa.csr is not None and len(tfa.dia_offsets) > 0,
            "the probes' plan has DIA offsets and residual edges")
    held = hold_flat_plan(torch, g, tfa, params, gen, dev,
                          path="drivers at scale", graph=workload,
                          n=g.n, entries=g.num_edges)
    worst.update((k, v) for k, v in held.items() if k != "inputs")
    emit(phase="drivers at scale holds", seconds=time.perf_counter() - t0,
         worst={k: list(v) for k, v in worst.items()})
    return worst


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs only on a "
              "GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import graph_embed_tpu_torch as gp
    from graph_embed_tpu_torch.graph import synth

    if sys.argv[1:2] == ["--multiprocess-rank"]:
        return multiprocess_rank(int(sys.argv[2]), sys.argv[3])
    dev = torch.device("cuda", 0)
    smi = phase_env(torch)
    phase_build()
    lj_prep = start_lj_prep()

    t0 = time.perf_counter()
    g = synth.mesh3d(MESH_SIDE)
    t1 = time.perf_counter()
    res = gp.partition_hierarchy(g, 0.1, emit_graphs=True)
    native_s = time.perf_counter() - t1
    emit(phase="setup", graph=f"mesh3d({MESH_SIDE})", n=g.n,
         stored_entries=g.num_edges, level_sizes=res.level_sizes,
         seconds=time.perf_counter() - t0, native_hierarchy_seconds=native_s)
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
    launches, f32_wall, main_coords = phase_main(torch, g, dev, 0.1)
    flat_launches = phase_flat(torch, flat, dev)
    phase_bench(torch, flat, dev)
    lj_launches = phase_lj(torch, lj, dev)
    phase_bf16_embed(torch, g, dev, f32_wall)
    for name, errs in phase_portable_embeds(torch, g, res, dev,
                                            main_coords).items():
        for key, v in zip(("max_abs_err", "max_err_over_scale"), errs):
            kernels[name][key] = max(kernels[name][key], v)
    kernels["ring_attraction"] = phase_halo(torch, lj, dev)
    halo_embed = phase_sharded_embed(torch, g, res, dev)
    worst, pipeline = phase_replicated(torch, g, res, lj, flat, main_coords,
                                       dev)
    for name, errs in worst.items():
        for key, v in zip(("max_abs_err", "max_err_over_scale"), errs):
            kernels[name][key] = max(kernels[name][key], v)
    phase_multiprocess(torch, g, res, lj, halo_embed, pipeline, dev)
    phase_profile(torch, g, res, flat, kernels, main_coords, dev)
    phase_determinism(torch, flat, lj, dev)
    phase_cli(dev)
    phase_device_partition(torch, g, res, native_s, flat, dev, main_coords)
    phase_run_tests(dev)
    phase_embedder(g, dev)
    pipe, prep_wait = start_pipeline(lj_prep, dev)
    for name, errs in phase_lj_scale(torch, dev, smi, prep_wait).items():
        for key, v in zip(("max_abs_err", "max_err_over_scale"), errs):
            kernels[name][key] = max(kernels[name][key], v)
    phase_drivers(dev)
    for name, errs in phase_drivers_at_scale(torch, dev, smi,
                                             pipe).items():
        for key, v in zip(("max_abs_err", "max_err_over_scale"), errs):
            kernels[name][key] = max(kernels[name][key], v)
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
    launches["ring_attraction"] = kernels["ring_attraction"]["launches"]

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
               "edge_linlog": (cu, f"{ref}:203"),
               "ring_attraction": (
                   "graph_embed_tpu_torch/csrc/ring_attraction.cu",
                   "graph_embed_tpu/parallel/overlap.py:155")}
    summary = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=int(launches[name]),
                    **{k: kernels[name][k] for k in (
                        "max_abs_err", "max_err_over_scale", "ms",
                        "host_ms", "plain_ms", "bound_ms", "bound_by",
                        "library_ms")})
               for name, (src, rep) in sources.items()]
    print(smi)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
