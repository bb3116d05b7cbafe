"""Profiler integration.

Counterpart of graph_embed_tpu/utils/profiling.py: ``torch.profiler``
traces in place of ``jax.profiler`` ones, in which the spans of
``utils.timing`` (the program's phases and ``timing.span``'s sub-spans)
appear as named regions above the kernels; ``device_ms`` splits a call's
time into the card's and the host's (bench_torch.py, chip_smoke.py).
Not carried over: the reference's persistent compilation cache
(``enable_compilation_cache``, ``_host_fingerprint``), XLA tooling;
``annotate`` (``timing.span`` names a region) and ``edges_per_second``
(one product, computed where it is reported).
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time

import torch


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """Trace the enclosed block with ``torch.profiler.profile`` over the
    CPU and, where a card is present, CUDA, and write it as a Chrome trace
    (``trace.json`` under ``logdir``; view it in Perfetto or
    chrome://tracing).  Yields the profiler, whose ``key_averages()`` sums
    the time by kernel; yields None, and traces nothing, when ``logdir``
    is None."""
    if logdir is None:
        yield None
        return
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def device_ms(fn, reps: int = 20, warmup: int = 3) -> tuple[float, float]:
    """(median milliseconds of ``fn`` on the card alone, median
    milliseconds the host takes to enqueue it).  Each timing enqueues
    ``fn`` behind a device sleep that outlasts the host's enqueueing, so
    the CUDA events around ``fn`` see the card's work back to back,
    without the host's dispatch between launches (which events around a
    plain call see wherever dispatch is slower than the card).  ``fn``
    must not wait on the card."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = 1 << 21
    dev, host = [], []
    while len(dev) < reps:
        e0, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        t0 = time.perf_counter()
        e0.record()
        torch.cuda._sleep(cycles)
        a.record()
        t1 = time.perf_counter()
        fn()
        b.record()
        t2 = time.perf_counter()
        b.synchronize()
        if (t2 - t0) * 1e3 >= e0.elapsed_time(a):
            # the card woke before the host had enqueued fn: sleep longer
            if cycles >= 1 << 34:
                raise RuntimeError("device_ms: the host took longer to "
                                   "enqueue fn than the longest sleep")
            cycles *= 2
            continue
        dev.append(a.elapsed_time(b))
        host.append((t2 - t1) * 1e3)
    return statistics.median(dev), statistics.median(host)
