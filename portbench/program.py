"""What the drivers hand the program and take from it: the benchmark's
graph as the program's card-only ``Graph``, and a ``MetricsLogger`` that
keeps every span (and, in a traced run, the card's busy time and kernels
inside it)."""

from __future__ import annotations

import contextlib
import time

import torch

from portbench import trace as TR


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def program_graph(arrays: dict):
    """The benchmark's graph as the program's ``Graph``, with no host copy
    (a graph that lives only on its device)."""
    from graph_embed_tpu_torch.graph.csr import Graph

    s, r, n = arrays["senders"], arrays["receivers"], arrays["n"]
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=s.device)
    torch.cumsum(torch.bincount(s, minlength=n), 0, out=indptr[1:])
    return Graph(indptr=indptr, senders=s, receivers=r,
                 weights=torch.ones(s.shape[0], dtype=torch.float32,
                                    device=s.device),
                 n=n, num_edges=int(s.shape[0]))


def span_logger(device, traced: bool):
    """A ``MetricsLogger`` for ``embed_graph(metrics=...)``.  Its
    ``records`` are the program's spans; with ``traced`` each span runs
    under its own profiler (CUDA activity only, no nesting: the embed's
    spans follow one another) and its record gains ``busy_s`` (the union
    of the card's intervals inside it) and ``kernels``."""
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
            self.log(phase=phase, seconds=seconds, **fields, **extra)

    return SpanLogger()
