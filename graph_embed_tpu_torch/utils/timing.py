"""The port's tracer: phase spans, the sub-spans and counters inside them,
and the kernel launches of each phase, kept in memory by a
``MetricsLogger``.

Counterpart of graph_embed_tpu/utils/timing.py.  A phase span on a CUDA
device closes with ``torch.cuda.synchronize``: PyTorch returns before the
card finishes, so a phase's seconds must wait for the device work queued
inside it.  (The JAX driver closed its spans with a scalar readback,
driver.py:180-184, a remote-TPU workaround.)

``embed_graph`` and ``embed`` make their logger current (``use``); code
underneath them records where the work happens through the module-level
``span`` and ``count``, which do nothing, and read no clock, where no
logger is current.  A sub-span never synchronizes: it measures the host's
time, and the device work queued inside it is placed by its stamps.
Every span carries ``t0_ns``/``t1_ns`` from ``time.time_ns``, the clock
in which ``torch.profiler`` reports its events (host and CUDA), and while
a profiler records, each span is also a ``record_function`` region, so a
Chrome trace (``utils.profiling.trace``) shows the spans above the
kernels they queued.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import time

import torch
import torch.autograd.profiler as _autograd_profiler

_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "graph_embed_tpu_torch.metrics", default=None)
_NULL = contextlib.nullcontext()


def _synchronize(device) -> None:
    """Wait for the work queued on ``device`` when it is a CUDA device."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _region(name: str):
    """A ``record_function`` region while a profiler records, else the
    shared null context."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NULL


def _launches() -> collections.Counter:
    from ..ops import cuda

    return collections.Counter(cuda.LAUNCHES)


class MetricsLogger:
    """Collects one record per phase in ``records``: ``phase``,
    ``seconds``, ``t0_ns``/``t1_ns`` and the span's fields (a record that
    ``log`` writes directly has only what it is given).  ``log`` adds, each
    only where non-empty:

    * ``sub``: the sub-spans opened since the previous record, in opening
      order, each {``name``, ``seconds``, ``t0_ns``, ``t1_ns``,
      ``parent`` (the index in ``sub`` of the enclosing sub-span, or
      None), its fields, ``counts``};
    * ``counts``: what ``count`` added outside any sub-span;
    * ``launches``: ``ops.cuda.LAUNCHES``'s growth since the previous
      record (or since ``use`` made the logger current).

    A unit counted goes to the innermost open sub-span, else to the
    phase, so a sum over a record's tree counts it once."""

    def __init__(self):
        self.records: list[dict] = []
        self._sub: list[dict] = []
        self._open: list[tuple[int, dict]] = []
        self._counts: dict = {}
        self._seen: collections.Counter | None = None

    def log(self, **record) -> dict:
        if self._sub:
            record["sub"], self._sub = self._sub, []
        if self._counts:
            record["counts"], self._counts = self._counts, {}
        if self._seen is not None:
            now = _launches()
            grown = now - self._seen
            if grown:
                record["launches"] = dict(grown)
            self._seen = now
        self.records.append(record)
        return record

    @contextlib.contextmanager
    def span(self, phase: str, device=None, **fields):
        """Time the body; on a CUDA ``device`` the span closes once the
        work queued inside it has finished."""
        t0_ns = time.time_ns()
        t0 = time.perf_counter()
        with _region(phase):
            yield
            _synchronize(device)
        seconds = time.perf_counter() - t0
        t1_ns = time.time_ns()
        self.log(phase=phase, seconds=seconds, t0_ns=t0_ns, t1_ns=t1_ns,
                 **fields)

    def _count(self, name: str, n) -> None:
        into = (self._open[-1][1].setdefault("counts", {}) if self._open
                else self._counts)
        into[name] = into.get(name, 0) + n


class _SubSpan:
    """One sub-span of the current logger (``span``)."""

    __slots__ = ("log", "rec", "region", "t0")

    def __init__(self, log: MetricsLogger, name: str, fields: dict):
        self.log = log
        self.rec = {"name": name, "seconds": None, "t0_ns": None,
                    "t1_ns": None, "parent": None, **fields}

    def __enter__(self):
        log, rec = self.log, self.rec
        if log._open:
            rec["parent"] = log._open[-1][0]
        log._open.append((len(log._sub), rec))
        log._sub.append(rec)
        rec["t0_ns"] = time.time_ns()
        self.region = _region(rec["name"])
        self.region.__enter__()
        self.t0 = time.perf_counter()
        return rec

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self.t0
        self.region.__exit__(*exc)
        self.rec.update(seconds=seconds, t1_ns=time.time_ns())
        self.log._open.pop()


@contextlib.contextmanager
def use(metrics: MetricsLogger):
    """Make ``metrics`` the current logger for the body (``span`` and
    ``count`` record into it); its launch count starts here unless it is
    current already."""
    if _CURRENT.get() is metrics:
        yield metrics
        return
    metrics._seen = _launches()
    token = _CURRENT.set(metrics)
    try:
        yield metrics
    finally:
        _CURRENT.reset(token)


def span(name: str, **fields):
    """A sub-span of the current logger's open phase, attached to the
    phase's record: the host's seconds and stamps of the body.  The
    shared null context where no logger is current."""
    log = _CURRENT.get()
    if log is None:
        return _NULL
    return _SubSpan(log, name, fields)


def count(name: str, n) -> None:
    """Add ``n`` to the counter ``name`` of the innermost open sub-span
    of the current logger, else of its phase; nothing where no logger is
    current."""
    log = _CURRENT.get()
    if log is not None:
        log._count(name, n)
