"""Community R-MAT graph drawn on the device (plain torch).

The recipe of the port's ``graph.synth.community_rmat``, copied so that
the benchmark owns its inputs: 2^scale ids in ``communities`` equal
blocks, inside each block an R-MAT draw of round(block * edge_factor)
directed pairs (the factor need not be whole) of one bit per level with
probabilities (a, b, c, 1 - a - b - c) and its ids permuted within the
block, then ``inter_frac`` of the intra draws spread uniformly over all
ids; self loops dropped, the largest connected component kept (as SNAP
kept com-LiveJournal's) and relabelled densely in id order, then
symmetrized with one unit-weight entry per stored pair.
Every block draws at once from a ``torch.Generator`` on the device, one
call per bit level, so a seed gives the same graph on every run;
``synth.community_rmat``'s numpy stream is not reproduced.
"""

from __future__ import annotations

import torch

from portbench.graphs import pairs


def build(cfg: dict, seed: int, device) -> dict:
    scale, ef = int(cfg["scale"]), float(cfg["edge_factor"])
    blocks = int(cfg["communities"])
    a, b, c = float(cfg["a"]), float(cfg["b"]), float(cfg["c"])
    lg = blocks.bit_length() - 1
    if (1 << lg) != blocks or scale - lg < 1:
        raise ValueError(f"{blocks} communities do not split 2^{scale} "
                         "ids into equal blocks")
    n, m = 1 << scale, 1 << (scale - lg)
    per = round(m * ef)
    gen = torch.Generator(device=device).manual_seed(seed)
    s = torch.zeros((blocks, per), dtype=torch.int64, device=device)
    r = torch.zeros_like(s)
    for _ in range(scale - lg):
        u = torch.rand((blocks, per), generator=gen, device=device)
        s = s * 2 + (u >= a + b)
        r = r * 2 + (((u >= a) & (u < a + b)) | (u >= a + b + c))
        del u
    # one permutation of the ids inside each block
    perm = torch.argsort(torch.rand((blocks, m), generator=gen,
                                    device=device), dim=1)
    first = (torch.arange(blocks, device=device) * m)[:, None]
    s = (first + torch.gather(perm, 1, s)).reshape(-1)
    r = (first + torch.gather(perm, 1, r)).reshape(-1)
    del perm
    inter = int(blocks * per * float(cfg["inter_frac"]))
    s = torch.cat([s, torch.randint(0, n, (inter,), generator=gen,
                                    device=device)])
    r = torch.cat([r, torch.randint(0, n, (inter,), generator=gen,
                                    device=device)])
    keep = s != r
    s, r = s[keep], r[keep]
    label = components(s, r, n)
    used = torch.zeros(n, dtype=torch.bool, device=device)
    used[s] = True
    used[r] = True
    sizes = torch.bincount(label[used], minlength=n)
    used &= label == int(torch.argmax(sizes))
    keep = used[s]
    s, r = s[keep], r[keep]
    relabel = torch.cumsum(used, 0) - 1
    return pairs(relabel[s], relabel[r], int(used.sum()))


def components(s: torch.Tensor, r: torch.Tensor, n: int) -> torch.Tensor:
    """[n] the least id of each id's connected component over the
    undirected pairs (s, r): the least label among the neighbours taken
    both ways, then the labels' chains followed to their ends, until
    nothing changes."""
    label = torch.arange(n, device=s.device)
    while True:
        low = label.clone()
        low.scatter_reduce_(0, s, label[r], "amin")
        low.scatter_reduce_(0, r, label[s], "amin")
        while True:
            hop = low[low]
            if torch.equal(hop, low):
                break
            low = hop
        if torch.equal(low, label):
            return label
        label = low
