"""Checkpoint / resume for the multilevel embed.

Counterpart of graph_embed_tpu/embed/checkpoint.py, in the same on-disk
format: one ``level_{l}.npz`` per completed level (its coordinates, and
below the base case the parent radii and the renormalized parent
coordinates) plus ``manifest.json`` listing the completed levels.  A store
written by either package loads in the other.  The driver derives every
level's seed up front, so a resumed embed equals a fresh one bitwise.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..graph.csr import Graph
from ..partition.interpolation import Partition


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


class CheckpointStore:
    """Directory-backed store: one .npz per completed level plus a
    manifest."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self._manifest = os.path.join(path, "manifest.json")

    def save_level(self, level: int, **arrays):
        np.savez(os.path.join(self.path, f"level_{level}.npz"),
                 **{k: _host(v) for k, v in arrays.items() if v is not None})
        state = self.read_manifest()
        state["completed"] = sorted(set(state.get("completed", []) + [level]))
        with open(self._manifest, "w") as f:
            json.dump(state, f)

    def load_level(self, level: int):
        p = os.path.join(self.path, f"level_{level}.npz")
        if not os.path.exists(p):
            return None
        with np.load(p) as z:
            return {k: z[k] for k in z.files}

    def read_manifest(self):
        if os.path.exists(self._manifest):
            with open(self._manifest) as f:
                return json.load(f)
        return {}

    def last_completed(self, k: int):
        """The finest level of the contiguous run k, k-1, ... of completed
        levels (levels run coarse to fine), or None."""
        done = set(self.read_manifest().get("completed", []))
        last = None
        for lvl in range(k, -1, -1):
            if lvl not in done:
                break
            last = lvl
        return last


def embed_resumable(graphs: list[Graph], parts: list[Partition],
                    dim: int = 3, *, store: CheckpointStore, device,
                    **embed_kw) -> torch.Tensor:
    """``driver.embed`` with a store: each level is saved as it completes
    and a rerun resumes after the last completed one.  Every ``embed``
    keyword works the same under resume."""
    from .driver import embed

    return embed(graphs, parts, dim, device=device, store=store, **embed_kw)
