"""Profiler integration.

Counterpart of graph_embed_tpu/utils/profiling.py: ``torch.profiler``
traces in place of ``jax.profiler`` ones, beside the per-phase spans of
``utils.timing``.  The reference's persistent compilation cache
(``enable_compilation_cache``, ``_host_fingerprint``) is XLA tooling and
is not carried over.
"""

from __future__ import annotations

import contextlib
import os

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


def annotate(name: str):
    """A named region inside a trace (``record_function``)."""
    return torch.profiler.record_function(name)


def edges_per_second(num_edges: int, iterations: int, seconds: float) -> float:
    """The north-star metric (BASELINE.md): stored entries traversed/s."""
    return num_edges * iterations / seconds
