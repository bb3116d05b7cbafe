"""Wall-clock spans: per-phase records, an accumulating timer and a
median of calls.

Counterpart of graph_embed_tpu/utils/timing.py.  A span on a CUDA device
closes with ``torch.cuda.synchronize``: PyTorch returns before the card
finishes, so a span's seconds must wait for the device work queued inside
it.  (The JAX driver closed its spans with a scalar readback,
driver.py:180-184, a remote-TPU workaround.)
"""

from __future__ import annotations

import contextlib
import time

import torch


def _synchronize(device) -> None:
    """Wait for the work queued on ``device`` when it is a CUDA device."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Timer:
    """Accumulating span timer: each ``with timer(device):`` adds one
    span's seconds to ``spans``, closed once ``device``'s queued work has
    finished (timing.py:20-39)."""

    def __init__(self, name: str = ""):
        self.name = name
        self.spans: list[float] = []

    @contextlib.contextmanager
    def __call__(self, device=None):
        t0 = time.perf_counter()
        yield
        _synchronize(device)
        self.spans.append(time.perf_counter() - t0)

    @property
    def total(self) -> float:
        return sum(self.spans)

    def __getitem__(self, i):
        return self.spans[i]


def time_fn(fn, *args, iters: int = 10, warmup: int = 2, device=None) -> float:
    """Median seconds of ``fn(*args)`` over ``iters`` calls after
    ``warmup`` (the upper one of an even count), each closed once
    ``device``'s queued work has finished (timing.py:62-72)."""
    for _ in range(warmup):
        fn(*args)
    _synchronize(device)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _synchronize(device)
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


class MetricsLogger:
    """Collects one record (a dict with ``phase`` and ``seconds``) per
    span in ``records``."""

    def __init__(self):
        self.records: list[dict] = []

    def log(self, **record) -> dict:
        self.records.append(record)
        return record

    @contextlib.contextmanager
    def span(self, phase: str, device=None, **fields):
        """Time the body; on a CUDA ``device`` the span closes once the
        work queued inside it has finished."""
        t0 = time.perf_counter()
        yield
        _synchronize(device)
        self.log(phase=phase, seconds=time.perf_counter() - t0, **fields)
