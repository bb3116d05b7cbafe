"""R-MAT power-law graph drawn on the device (plain torch).

The recipe of the port's ``graph.synth.rmat`` (the Graph500 Kronecker
draw), copied so that the benchmark owns its inputs: n = 2^scale ids,
round(n * edge_factor) directed draws (the factor need not be whole) of
one bit per level with probabilities (a, b, c, 1 - a - b - c), ids
permuted, self loops and isolated vertices dropped and the rest
relabelled densely, then symmetrized with one unit-weight entry per
stored pair (bench.py's ``unit_weights``).  The
draws come from a ``torch.Generator`` on the device, in one call per bit
level, so a seed gives the same graph on every run; ``synth.rmat``'s
numpy stream is not reproduced.
"""

from __future__ import annotations

import torch

from portbench.graphs import pairs


def build(cfg: dict, seed: int, device) -> dict:
    scale, ef = int(cfg["scale"]), float(cfg["edge_factor"])
    a, b, c = float(cfg["a"]), float(cfg["b"]), float(cfg["c"])
    n = 1 << scale
    draws = round(n * ef)
    gen = torch.Generator(device=device).manual_seed(seed)
    s = torch.zeros(draws, dtype=torch.int64, device=device)
    r = torch.zeros_like(s)
    for _ in range(scale):
        u = torch.rand(draws, generator=gen, device=device)
        s = s * 2 + (u >= a + b)
        r = r * 2 + (((u >= a) & (u < a + b)) | (u >= a + b + c))
    perm = torch.randperm(n, generator=gen, device=device)
    s, r = perm[s], perm[r]
    keep = s != r
    s, r = s[keep], r[keep]
    used = torch.zeros(n, dtype=torch.bool, device=device)
    used[s] = True
    used[r] = True
    relabel = torch.cumsum(used, 0) - 1
    n = int(used.sum())
    return pairs(relabel[s], relabel[r], n)

