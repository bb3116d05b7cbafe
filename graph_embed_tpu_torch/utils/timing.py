"""Per-phase wall-clock spans as structured records.

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
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        self.log(phase=phase, seconds=time.perf_counter() - t0, **fields)
