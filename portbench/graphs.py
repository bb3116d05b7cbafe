"""What the graph generators share (plain torch)."""

from __future__ import annotations

import torch


def pairs(s: torch.Tensor, r: torch.Tensor, n: int) -> dict:
    """{"n", "senders", "receivers"}: both directions of every (s, r),
    duplicates dropped, sorted by (sender, receiver), unit weights."""
    key = torch.unique(torch.cat([s * n + r, r * n + s]))
    return {"n": n, "senders": key // n, "receivers": key % n}
