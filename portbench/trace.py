"""The card's side of a traced run, from ``torch.profiler`` (CUPTI).

``profile()`` traces CUDA activity only, so the host's own operators are
neither recorded nor slowed; the events stay in memory (no Chrome trace
is written).  ``reduce`` takes the device intervals of one or more
profilers and gives the card's busy seconds (the union of its intervals),
each kernel's calls and seconds under the names of ``kernels.json`` (the
program's CUDA function names; any other kernel keeps a short form of its
own name), and the idle gaps between consecutive device intervals.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import json
import os
import re

import torch

with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "kernels.json")) as _fh:
    KERNELS = json.load(_fh)
_PATTERNS = [(name, re.compile(rf"(?<![A-Za-z0-9_]){fn}\b"))
             for name, fn in KERNELS.items()]


def profile(device):
    """A profiler of the card's activity, or a context that yields None
    on the CPU, where there is no device to trace."""
    if torch.device(device).type != "cuda":
        return contextlib.nullcontext()
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])


@functools.lru_cache(maxsize=4096)
def kernel_name(raw: str) -> str:
    """``kernels.json``'s name for a profiled kernel, else a short form
    of its own name (no return type, template arguments or parameters)."""
    for name, pat in _PATTERNS:
        if pat.search(raw):
            return name
    short = re.sub(r"^void\s+|\(anonymous namespace\)::", "", raw)
    short = re.split(r"[<(]", short, maxsplit=1)[0]
    return short.rsplit("::", 1)[-1][:64].strip() or raw[:64]


def device_intervals(prof) -> list[tuple[int, int, str]]:
    """[(start_ns, end_ns, name)] of every device activity (kernels,
    copies, fills) a profiler saw, in start order."""
    kineto = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    out = []
    cuda = torch.autograd.DeviceType.CUDA
    if kineto is not None:
        for e in kineto.events():
            if e.device_type() == cuda:
                start = e.start_ns()
                out.append((start, start + e.duration_ns(), e.name()))
    else:
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                out.append((int(e.time_range.start * 1e3),
                            int(e.time_range.end * 1e3), e.name))
    out.sort()
    return out


def reduce(intervals: list[tuple[int, int, str]]) -> dict:
    """{"busy_s", "kernels": {name: {"calls", "seconds"}}, "gaps":
    [(label, seconds)]}: the union of the intervals, each kernel's
    summed device time, and every idle gap between one interval's end
    (the furthest so far) and the next start, labelled "a -> b" by the
    kernels on either side."""
    calls = collections.Counter()
    secs = collections.Counter()
    busy, end, last = 0, None, None
    gaps = []
    for lo, hi, raw in intervals:
        name = kernel_name(raw)
        calls[name] += 1
        secs[name] += (hi - lo) * 1e-9
        if end is None:
            busy += hi - lo
            end, last = hi, name
            continue
        if lo > end:
            gaps.append((f"{last} -> {name}", (lo - end) * 1e-9))
        if hi > end:
            busy += hi - max(lo, end)
            end, last = hi, name
    return {"busy_s": busy * 1e-9,
            "kernels": {k: {"calls": calls[k], "seconds": secs[k]}
                        for k in calls},
            "gaps": gaps}


def top(pairs, k: int = 10) -> list:
    """The ``k`` largest [name, seconds] of (name, seconds) pairs, summed
    by name."""
    total = collections.Counter()
    for name, s in pairs:
        total[name] += s
    return [[name, s] for name, s in total.most_common(k)]
