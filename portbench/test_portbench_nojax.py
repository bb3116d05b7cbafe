"""Nothing the harness, its drivers, the program or the reference load is
JAX or the JAX package (top-level names compared whole), and the
reference loads nothing of the program."""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys

from portbench.conftest import ROOT

BANNED = {"jax", "jaxlib", "flax", "graph_embed_tpu"}


def loaded_tops(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + """
import json, sys
print(json.dumps(sorted({m.split('.', 1)[0] for m in list(sys.modules)})))
"""], capture_output=True, text=True, timeout=600, cwd=ROOT,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax(tmp_path):
    """A whole run of a small cell on the CPU, every module of the
    benchmark loaded besides."""
    code = f"""
import glob, os, sys
sys.path.insert(0, {ROOT!r})
sys.path.insert(1, {os.path.join(ROOT, 'portbench')!r})
from conftest import make_checkout
from portbench import harness, control, trace
root = make_checkout({str(tmp_path)!r}, [("lj-rmat24.flat", "lj-rmat24",
                     "flat")], {{"lj-rmat24": {{"scale": 8}}}})
harness.run_cell(root, "lj-rmat24.flat", 2**31 + 1, 0.2, True, "cpu")
for kind in ("drivers", "generators", "metrics", "reference"):
    for p in glob.glob(os.path.join({ROOT!r}, "portbench", kind, "*.py")):
        harness.load_module({ROOT!r}, kind,
                            os.path.basename(p)[:-3])
"""
    tops = loaded_tops(code)
    assert "graph_embed_tpu_torch" in tops  # the program did run
    assert not tops & BANNED, tops & BANNED


def test_the_reference_loads_nothing_of_the_program():
    paths = glob.glob(os.path.join(ROOT, "portbench", "reference", "*.py"))
    assert paths
    code = f"""
import sys
sys.path.insert(0, {ROOT!r})
import importlib
for name in {sorted(os.path.basename(p)[:-3] for p in paths)!r}:
    importlib.import_module("portbench.reference." + name)
"""
    tops = loaded_tops(code)
    assert not tops & (BANNED | {"graph_embed_tpu_torch"})
