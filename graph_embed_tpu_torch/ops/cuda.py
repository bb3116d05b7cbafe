"""Build and load the hand-written CUDA kernels of ``csrc/``.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ctypes (pointers and
the stream travel as ``c_void_p``).  The build runs at first use into
``_build/kernels`` (listed in ``.gitignore``) and is atomic: nvcc writes a
per-pid temporary that ``os.replace`` publishes.  Nothing here runs at
import time, so CPU-only machines import the package without a toolkit.

``LAUNCHES`` counts kernel launches by name; each wrapper adds one where it
launches its kernel, so a run can show that its main path went through
the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import glob
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build", "kernels")
LIB_PATH = os.path.join(BUILD_DIR, "libge_kernels.so")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel B's slots per CTA (TILE in csrc/bucket_repulsion.cu); the layout's
# CTA table is cut in these steps, and ``library`` checks that the built
# kernel agrees
BUCKET_TILE = 256

LAUNCHES: collections.Counter = collections.Counter()

_LOCK = threading.Lock()
_LIB = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "graph_embed_tpu_torch build only where the CUDA "
                           "toolkit is installed")
    return found


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def build() -> str:
    """Compile ``csrc/*.cu`` into ``LIB_PATH`` unless it is newer than every
    source.  Returns the compiler's report (registers, shared memory and
    spills per kernel, from ``-Xptxas -v``), empty when nothing was built."""
    srcs = sources()
    if os.path.exists(LIB_PATH) and all(
            os.path.getmtime(LIB_PATH) >= os.path.getmtime(s) for s in srcs):
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.tmp.{os.getpid()}"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed:\n" + proc.stdout + proc.stderr)
        os.replace(tmp, LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return proc.stdout + proc.stderr


def library():
    """The loaded kernel library (built on first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            build()
            lib = ctypes.CDLL(LIB_PATH)
            p = ctypes.c_void_p
            lib.ge_edge_spmm.restype = ctypes.c_int
            lib.ge_edge_spmm.argtypes = [ctypes.c_int, ctypes.c_int,
                                         p, p, p, p, p, p]
            lib.ge_bucket_repulsion.restype = ctypes.c_int
            lib.ge_bucket_repulsion.argtypes = [
                ctypes.c_int, ctypes.c_int, p, p, p, p,
                ctypes.c_float, ctypes.c_float, p]
            lib.ge_error_string.restype = ctypes.c_char_p
            lib.ge_error_string.argtypes = [ctypes.c_int]
            lib.ge_bucket_tile.restype = ctypes.c_int
            lib.ge_bucket_tile.argtypes = []
            if lib.ge_bucket_tile() != BUCKET_TILE:
                raise RuntimeError(
                    f"kernel B was built with {lib.ge_bucket_tile()} slots "
                    f"per CTA, the layout cuts {BUCKET_TILE}")
            _LIB = lib
    return _LIB


def check(rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if rc != 0:
        msg = library().ge_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"error {rc} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
