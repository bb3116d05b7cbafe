"""Native (C++) host backends: g++ builds of the JAX package's sources,
loaded with ctypes.

The sources are read by path from ``graph_embed_tpu/native/`` (the
coarsener and the first-collision sweep are host code shared by both
packages); the libraries are built into this package's own build directory
so nothing is written into the reference tree.  Builds are atomic: g++
writes a per-pid temporary and ``os.replace`` publishes it, so concurrent
processes (parallel test workers) never load a half-written library.
"""

from __future__ import annotations

import os
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(os.path.dirname(_PKG), "graph_embed_tpu", "native")
BUILD_DIR = os.path.join(_PKG, "_build", "native")


def build_shared(src: str, so: str, extra_flags: tuple = ()) -> str:
    """Compile ``src`` into shared library ``so`` atomically; skipped when
    ``so`` is newer than ``src``."""
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return so
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.tmp.{os.getpid()}"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
           *extra_flags, src, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise OSError(f"g++ failed on {src}:\n{proc.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so


def build_native(name: str) -> str:
    """Build ``graph_embed_tpu/native/<name>.cpp`` into the port's build
    directory.  FMA contraction is off: the C++ must round like numpy."""
    return build_shared(os.path.join(SRC_DIR, f"{name}.cpp"),
                        os.path.join(BUILD_DIR, f"_{name}.so"),
                        extra_flags=("-ffp-contract=off",))
