"""Build and load the hand-written CUDA kernels of ``csrc/``.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process for
``sm_90a`` (all started together), and the objects are linked into one
shared library with a plain C interface, loaded with ctypes (pointers and
the stream travel as ``c_void_p``).  The build runs at first use into
``_build/kernels`` (listed in ``.gitignore``) and is atomic: objects and the
library are per-pid temporaries that ``os.replace`` publishes.  Nothing
here runs at import time, so CPU-only machines import the package without
a toolkit.

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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v")

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
    """The translation units, one nvcc process each."""
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _inputs() -> list[str]:
    return sources() + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def build() -> str:
    """Compile ``csrc/*.cu`` into ``LIB_PATH`` unless it is newer than every
    source and header.  Returns the compiler's report (registers, shared
    memory and spills per kernel, from ``-Xptxas -v``), empty when nothing
    was built."""
    if os.path.exists(LIB_PATH) and all(
            os.path.getmtime(LIB_PATH) >= os.path.getmtime(s)
            for s in _inputs()):
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = f"tmp.{os.getpid()}"
    objs = [os.path.join(BUILD_DIR, os.path.basename(src) + f".{tag}.o")
            for src in sources()]
    tmp = f"{LIB_PATH}.{tag}"
    report = []
    try:
        procs = [subprocess.Popen([nvcc, *COMPILE_FLAGS, "-c", "-o", obj,
                                   src], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(sources(), objs)]
        failed = []
        for src, proc in zip(sources(), procs):
            out = proc.communicate()[0]
            report.append(out)
            if proc.returncode != 0:
                failed.append(f"{os.path.basename(src)}:\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", tmp,
                               *objs], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout
                               + link.stderr)
        os.replace(tmp, LIB_PATH)
    finally:
        for path in (*objs, tmp):
            if os.path.exists(path):
                os.remove(path)
    return "".join(report)


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
            for fn in (lib.ge_edge_spmm_bf16x, lib.ge_edge_spmm_null):
                fn.restype = ctypes.c_int
                fn.argtypes = [ctypes.c_int, ctypes.c_int, p, p, p, p, p]
            lib.ge_bucket_repulsion.restype = ctypes.c_int
            lib.ge_bucket_repulsion.argtypes = [
                ctypes.c_int, ctypes.c_int, p, p, p, p,
                ctypes.c_float, ctypes.c_float, p]
            f = ctypes.c_float
            lib.ge_edge_linlog.restype = ctypes.c_int
            lib.ge_edge_linlog.argtypes = [ctypes.c_int, ctypes.c_int,
                                           p, p, p, p, p, f, f, p]
            lib.ge_sampled_repulsion.restype = ctypes.c_int
            lib.ge_sampled_repulsion.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.c_int, p, p, p, f, f, p,
                p]
            lib.ge_fused_step.restype = ctypes.c_int
            lib.ge_fused_step.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                p, p, p, p, p, p, p, p, f, f, f, f, f, f, f, p, p, p]
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
