"""Where an entry point runs.

Entry points (``force_atlas``, ``force_atlas_tiled``, ``halo_force_atlas``,
``make_mesh``) take ``device="cuda"`` by default and move their inputs
there.  A machine without a card raises rather than running the plain
versions on the CPU behind the caller's back; the CPU runs only when the
caller asks for it (``device="cpu"``, as the tests do).
"""

from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """``device`` as a ``torch.device``, checked: CUDA must exist when
    asked for, and only CUDA and the CPU are taken."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was asked for but no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch versions "
            "on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the port runs on CUDA or the CPU, not {dev}")
    return dev
