"""Fixtures of the benchmark's own tests (run from the repository's root:
``python -m pytest portbench``).  They import neither JAX nor the JAX
package."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def make_checkout(tmp, cells, sizes, per_layer=()):
    """A checkout at ``tmp`` with this benchmark's folder and a
    BENCHMARK.json naming ``cells`` [(name, config, traffic)], each
    configuration's file shrunk by ``sizes`` {config: {key: value}}, and
    the per-layer metrics ``per_layer`` [(name, cells, moves)]."""
    shutil.copytree(os.path.join(ROOT, "portbench"),
                    os.path.join(tmp, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    configs = []
    for name in sorted({c for _, c, _ in cells}):
        path = os.path.join("portbench", "configs", f"{name}.json")
        with open(os.path.join(tmp, path)) as fh:
            cfg = json.load(fh)
        cfg.update(sizes.get(name, {}))
        with open(os.path.join(tmp, path), "w") as fh:
            json.dump(cfg, fh)
        configs.append({"name": name, "source": cfg["source"],
                        "file": path, "reduced": [], "why": "test"})
    bench = {
        "command": ["python3", "portbench/run.py"], "paths": ["portbench"],
        "run_seconds": 1, "configs": configs,
        "workloads": [{"name": n, "config": c, "traffic": t, "chips": 1,
                       "why": "test"} for n, c, t in cells],
        "end_to_end": [
            {"name": "fa_entries_per_s", "unit": "entries/s",
             "better": "higher", "bound": 0.25, "source": "host_clock",
             "workloads": [n for n, _, t in cells if t == "flat"]},
            {"name": "embed_s", "unit": "s", "better": "lower",
             "bound": 0.25, "source": "host_clock",
             "workloads": [n for n, _, t in cells if t == "embed"]},
            {"name": "setup_s", "unit": "s", "better": "lower",
             "bound": 0.25, "source": "host_clock"}],
        "per_layer": [
            {"name": m, "unit": "s" if m.endswith("_s") else "%",
             "better": "higher",
             "source": "device_trace", "layer": "test",
             "moves": moves, "workloads": list(w)}
            for m, w, moves in per_layer],
    }
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    return str(tmp)


@pytest.fixture
def card():
    """The CUDA device, or a skip where this machine has none (decided
    here, never while a module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
