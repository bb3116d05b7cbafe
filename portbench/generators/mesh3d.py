"""L^3 grid with six neighbours, built on the device (plain torch).

The lattice of the port's ``graph.synth.mesh3d`` (no long-range extras),
copied so that the benchmark owns its inputs: vertex id x + L y + L^2 z,
an edge to the next vertex along each axis, both directions stored, unit
weights.  The seed plays no part: every run lays out the same graph.
"""

from __future__ import annotations

import torch

from portbench.graphs import pairs


def build(cfg: dict, seed: int, device) -> dict:
    L = int(cfg["side"])
    n = L ** 3
    idx = torch.arange(n, device=device)
    x, y, z = idx % L, (idx // L) % L, idx // (L * L)
    ss, rr = [], []
    for dx, dy, dz in ((1, 0, 0), (0, 1, 0), (0, 0, 1)):
        m = (x + dx < L) & (y + dy < L) & (z + dz < L)
        ss.append(idx[m])
        rr.append(idx[m] + dx + dy * L + dz * L * L)
    return pairs(torch.cat(ss), torch.cat(rr), n)
