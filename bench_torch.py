"""Benchmark: the port's flat ForceAtlas iteration in stored entries per
second on one CUDA card.

    python3 bench_torch.py                              # both workloads
    python3 bench_torch.py --workload scattered [--shape B,W,T]
    python3 bench_torch.py --device cpu                 # the plain versions

The port of bench.py onto graph_embed_tpu_torch; it imports neither JAX
nor the JAX package.  It prints ONE JSON line last:
  {"metric": "fa_edges_per_sec_per_chip", "value": N, "unit": "edges/s",
   "headline_workload": ..., "workloads": {...},
   "device": {"name": ..., "power_limit": ...}}

Metric (bench.py:7-11): stored adjacency entries traversed per second by
the full flat ForceAtlas iteration -- attraction (DIA offsets, and kernel
A over the residual edges), sampled repulsion at 64 samples, gravity and
the adaptive speed schedule, all but kernel A inside kernel D -- on one
card.  bench.py's ``vs_baseline`` is dropped: it divides by a target set
for the TPU, no speed target is carried over to the port, and the first
run of the benchmark on the card sets the baseline.

Workloads (bench.py:50-73):

* ``mesh``      -- mesh3d(128), 2,097,152 vertices and 12,484,608 stored
                   entries.  DIA absorbs every edge: an iteration is one
                   launch of kernel D.
* ``scattered`` -- rmat(20, 8, seed=1) rebuilt with unit weights
                   (``unit_weights``), planned at (sender_block, window,
                   tile) = (4096, 4096, 1024), which ``--shape B,W,T``
                   overrides: an iteration is kernel A (unit) over the
                   residual edges, then kernel D.

Timing (bench.py:76-119): the start is U(-1, 1)^3 from a torch.Generator
on the device seeded with 0, drawn outside the timed window, with f_prev
zero.  One warm-up call of 20 iterations, closed by a host readback,
builds the kernels at first use and settles the card; then 5 calls of 20
iterations, each carrying the state on from the last and drawing its
sample ids from the generator re-seeded with the call's index (bench.py's
``PRNGKey(i)``), each timed by the host clock up to and including the
host readback of its checksum.  ``value`` is the stored entries over the
median seconds per iteration.

Beside the metric each workload's record holds the card's view of the same
calls: ``events_ms_per_iteration`` (CUDA events around each of the 5
calls, median), ``card_ms_per_iteration`` and ``enqueue_ms_per_iteration``
(one call enqueued behind a device sleep, ``utils.profiling.device_ms``:
the card's time without the host's gaps, and the host's time to enqueue
the call), ``launches_per_iteration`` (``ops.cuda.LAUNCHES`` over the 5
calls; a card run raises unless it is exactly kernel D's one launch, and
on ``scattered`` kernel A's), ``peak_bytes``, ``prepare_tiled_seconds``,
``n`` and ``edges``.

Each workload runs in its own subprocess with ``WORKLOAD_TIMEOUT_S``.  The
headline is the worse workload; a failed or timed-out workload pins its
value to 0 and makes the exit code 1.  The card is the default; without
one the children fail (no CPU fallback) and the line reads 0.  ``--device
cpu`` runs the plain versions, for the small-size tests only.  Nothing is
written but standard output.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from graph_embed_tpu_torch.forceatlas import tiled as TL
from graph_embed_tpu_torch.graph import synth
from graph_embed_tpu_torch.graph.csr import from_edges
from graph_embed_tpu_torch.ops import cuda
from graph_embed_tpu_torch.utils.device import resolve
from graph_embed_tpu_torch.utils.params import ForceAtlasParams
from graph_embed_tpu_torch.utils.profiling import device_ms

WORKLOAD_TIMEOUT_S = 1500
WORKLOADS = ("mesh", "scattered")
# scattered-optimal shape on the reference (bench.py:71-72)
SCATTERED_SHAPE = (4096, 4096, 1024)


def unit_weights(g):
    """``g`` with one unit-weight entry per stored pair (bench.py:66-70):
    ``synth.rmat`` counts duplicate draws in its weights, while the
    social graphs it stands for are unweighted."""
    s, r, _ = g.to_coo_numpy()
    return from_edges(s, r, np.ones(s.size, np.float32), n=g.n,
                      symmetrize=False)


def build_graph(workload: str, shape: tuple | None = None):
    """(graph on the host, ``prepare_tiled`` shape keywords)."""
    if workload == "mesh":
        if shape is not None:
            raise ValueError("--shape only applies to --workload scattered "
                             "(the mesh workload rides the fused DIA step, "
                             "no windowed tiling to shape)")
        return synth.mesh3d(128), {}
    if workload != "scattered":
        raise ValueError(f"unknown workload {workload!r}")
    g = unit_weights(synth.rmat(20, 8, seed=1))
    B, W, T = shape or SCATTERED_SHAPE
    return g, dict(sender_block=B, window=W, tile=T)


def bench_params(num_samples: int = 64) -> ForceAtlasParams:
    return ForceAtlasParams(repulsion="sampled",
                            num_negative_samples=num_samples)


def check_precision() -> None:
    """The step's float32 products must stay float32 (no TF32)."""
    if (torch.get_float32_matmul_precision() != "highest"
            or torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError("float32 matmuls must run at 'highest' "
                           "precision, TF32 off")


def card_label(device: torch.device) -> str:
    """"cpu", or the card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them for
    ``device``'s index (a card capped below its maximum power runs
    slower, so a time is kept beside the limit it was taken under)."""
    if device.type == "cpu":
        return "cpu"
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()


def expected_launches(tfa: TL.TiledFA) -> dict:
    """The launches of one fused iteration at float32 x: kernel A over
    the residual edges, if any, in its CSR's mode, then kernel D."""
    want = {"fused_step": 1}
    if tfa.csr is not None:
        want[f"edge_spmm[{tfa.csr.kind}]"] = 1
    return want


def run(x, f, tfa: TL.TiledFA, params: ForceAtlasParams, iters: int, *,
        generator: torch.Generator | None = None, sample_ids=None):
    """``iters`` calls of ``fa_step_tiled`` from (x, f), bench.py's loop
    (bench.py:92-101).  Step ``i`` draws its sample ids from
    ``generator``, or takes ``sample_ids[i]``.  Returns (x, f, checksum):
    the checksum is x.sum() on x's device, for the host to read."""
    for it in range(iters):
        idx = None if sample_ids is None else sample_ids[it]
        x, f = TL.fa_step_tiled(x, f, tfa, params, sample_idx=idx,
                                generator=generator)
    return x, f, x.sum()


def time_plan(g, tfa: TL.TiledFA, params: ForceAtlasParams, *,
              iters_per_call: int = 20, repeats: int = 5) -> dict:
    """Time ``run`` on a prepared plan as bench.py does (see the module's
    docstring); returns the record without the workload's name and the
    plan's seconds.  Raises if the coordinates come out non-finite or, on
    the card, if an iteration launched other than ``expected_launches``."""
    if not TL.fused_applies(tfa, params):
        raise ValueError("the bench times the fused step: sampled "
                         "repulsion, not linlog, with some attraction")
    dev = tfa.device
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((g.n, tfa.dim), generator=gen, dtype=torch.float32,
                   device=dev) * 2.0 - 1.0
    f = torch.zeros_like(x)
    x, f, chk = run(x, f, tfa, params, iters_per_call, generator=gen)
    float(chk)  # builds the kernels at first use, settles the card
    cuda.LAUNCHES.clear()
    times, events = [], []
    for i in range(repeats):
        if on_card:
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        gen.manual_seed(i)
        t0 = time.perf_counter()
        if on_card:
            a.record()
        x, f, chk = run(x, f, tfa, params, iters_per_call, generator=gen)
        if on_card:
            b.record()
        checksum = float(chk)  # the host readback closes the timing
        times.append(time.perf_counter() - t0)
        if on_card:
            b.synchronize()
            events.append(a.elapsed_time(b))
    total = repeats * iters_per_call
    launches = {k: v // total if v % total == 0 else v / total
                for k, v in sorted(cuda.LAUNCHES.items())}
    if tuple(x.shape) != (g.n, tfa.dim) or not bool(torch.isfinite(x).all()):
        raise RuntimeError("the bench loop left non-finite coordinates")
    if on_card and launches != expected_launches(tfa):
        raise RuntimeError(f"launches per iteration {launches}, expected "
                           f"{expected_launches(tfa)}")
    sec_per_iter = statistics.median(times) / iters_per_call
    rec = {"edges_per_sec": g.num_edges / sec_per_iter,
           "ms_per_iteration": sec_per_iter * 1e3,
           "ms_per_iteration_all": [t / iters_per_call * 1e3 for t in times],
           "events_ms_per_iteration": None, "card_ms_per_iteration": None,
           "enqueue_ms_per_iteration": None,
           "launches_per_iteration": launches, "peak_bytes": None,
           "checksum": checksum, "iterations": iters_per_call,
           "repeats": repeats, "n": g.n, "edges": g.num_edges}
    if on_card:
        card, host = device_ms(lambda: run(x, f, tfa, params, iters_per_call,
                                           generator=gen))
        rec.update(events_ms_per_iteration=statistics.median(events)
                   / iters_per_call,
                   card_ms_per_iteration=card / iters_per_call,
                   enqueue_ms_per_iteration=host / iters_per_call,
                   peak_bytes=torch.cuda.max_memory_allocated(dev))
    return rec


def bench_fa(workload: str, iters_per_call=20, repeats=5, dim=3,
             num_samples=64, shape=None, *, device="cuda") -> dict:
    """One workload's record, the child's JSON line: the graph built on
    the host, moved to ``device`` (the card unless "cpu" is asked for),
    planned, then timed by ``time_plan``."""
    dev = resolve(device)
    check_precision()
    g, tile_kw = build_graph(workload, shape)
    g = g.to(dev)
    params = bench_params(num_samples)
    t0 = time.perf_counter()
    tfa = TL.prepare_tiled(g, dim, params, **tile_kw)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    prep = time.perf_counter() - t0
    rec = time_plan(g, tfa, params, iters_per_call=iters_per_call,
                    repeats=repeats)
    return {"workload": workload, **rec, "prepare_tiled_seconds": prep,
            "device": card_label(dev)}


def run_child(workload: str, device: str = "cuda") -> dict | None:
    cmd = [sys.executable, os.path.abspath(__file__), "--workload", workload,
           "--device", device]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=WORKLOAD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        print(f"workload {workload}: timed out", file=sys.stderr)
        return None
    for line in reversed(proc.stdout.splitlines()):
        line = line.strip()
        if line.startswith("{"):
            return json.loads(line)
    print(f"workload {workload}: no result "
          f"(rc={proc.returncode}):\n{proc.stderr[-2000:]}", file=sys.stderr)
    return None


def device_fields(label: str) -> dict:
    """{"name", "power_limit"} from a ``card_label``."""
    name, _, limit = label.rpartition(", ")
    return {"name": name, "power_limit": limit} if name \
        else {"name": label, "power_limit": None}


def parse_shape(text: str) -> tuple:
    shape = tuple(int(v) for v in text.split(","))
    if len(shape) != 3:
        raise argparse.ArgumentTypeError("--shape takes B,W,T")
    return shape


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Time the port's flat ForceAtlas step (bench.py's "
                    "metric and workloads).")
    ap.add_argument("--workload", choices=WORKLOADS,
                    help="run one workload in this process (a child)")
    ap.add_argument("--shape", type=parse_shape,
                    help="sender_block,window,tile of the scattered plan")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.workload:
        rec = bench_fa(args.workload, shape=args.shape, device=args.device)
        print(json.dumps(rec))
        return 0
    if args.shape is not None:
        ap.error("--shape needs --workload scattered")

    results = {}
    failed = []
    for wl in WORKLOADS:
        r = run_child(wl, args.device)
        if r is not None:
            results[wl] = {"value": r.pop("edges_per_sec"), **r}
        else:
            # a failed workload pins the headline to 0: the worst-of rule
            # must not promote the survivor
            failed.append(wl)
            results[wl] = {"value": 0.0,
                           "error": "workload failed or timed out"}
    out = {"metric": "fa_edges_per_sec_per_chip", "value": 0.0,
           "unit": "edges/s"}
    if len(failed) == len(WORKLOADS):
        out.update(error="all workloads failed", workloads=results,
                   failed_workloads=failed)
        print(json.dumps(out))
        return 1
    # the headline is the worse workload, so the line cannot overstate the
    # family the metric names
    worst = min(results, key=lambda k: results[k]["value"])
    ran = next(r for r in results.values() if "device" in r)
    out.update(value=results[worst]["value"], headline_workload=worst,
               workloads=results, device=device_fields(ran["device"]))
    if failed:
        out["failed_workloads"] = failed
    print(json.dumps(out))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
