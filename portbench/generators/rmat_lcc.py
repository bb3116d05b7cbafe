"""The largest connected component of an R-MAT power-law graph, drawn on
the device (plain torch).

``rmat.build``'s draw (``synth.rmat``'s recipe: ids permuted, self loops
and isolated vertices dropped, one unit-weight entry per direction of
each distinct pair), then ``community_rmat.components``' labels: only the
largest component is kept, as SNAP kept com-LiveJournal's, and relabelled
densely in id order, so the entries stay sorted by (sender, receiver).
"""

from __future__ import annotations

import torch

from portbench.generators import community_rmat, rmat


def build(cfg: dict, seed: int, device) -> dict:
    g = rmat.build(cfg, seed, device)
    s, r, n = g["senders"], g["receivers"], g["n"]
    label = community_rmat.components(s, r, n)
    kept = label == int(torch.argmax(torch.bincount(label, minlength=n)))
    relabel = torch.cumsum(kept, 0) - 1
    inside = kept[s]  # an entry lies in the component with its sender
    return {"n": int(kept.sum()), "senders": relabel[s[inside]],
            "receivers": relabel[r[inside]]}
