"""ctypes binding of the native first-collision sweep (``csrc/sweep.cpp``,
a copy of graph_embed_tpu/native/sweep.cpp), built on first use.  The sweep pops
the alive pair of least (tau, pair index) from a heap, bit-identical to
the JAX package's Python heap (graph_embed_tpu/embed/radii.py:84-134)."""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from . import build_native

_LOCK = threading.Lock()
_LIB = None


def _lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build_native("sweep"))
            for name in ("ge_sweep_run_f32", "ge_sweep_run_f64"):
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int64
                fn.argtypes = [ctypes.c_int64, ctypes.c_int64,
                               ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_void_p, ctypes.c_void_p]
            for name in ("ge_sweep_batch_f32", "ge_sweep_batch_f64"):
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int64
                fn.argtypes = [ctypes.c_int64] + [ctypes.c_void_p] * 6
            _LIB = lib
    return _LIB


def available() -> bool:
    """Whether the library builds and loads here (g++ present)."""
    try:
        _lib()
    except OSError:
        return False
    return True


def _float(tau0, lib, stem: str):
    tau0 = np.ascontiguousarray(tau0)
    if tau0.dtype == np.float32:
        return tau0, getattr(lib, stem + "_f32")
    return (np.ascontiguousarray(tau0, dtype=np.float64),
            getattr(lib, stem + "_f64"))


def sweep_run(tau0, pi, pj, num_local: int) -> np.ndarray:
    """First-collision sweep over one candidate list.

    tau0: [P] initial times; pi/pj: [P] vertex ids in [0, num_local).
    Returns r [num_local] in tau0's dtype (0 = never assigned)."""
    lib = _lib()
    tau0, fn = _float(tau0, lib, "ge_sweep_run")
    pi = np.ascontiguousarray(pi, dtype=np.int32)
    pj = np.ascontiguousarray(pj, dtype=np.int32)
    r = np.empty(int(num_local), dtype=tau0.dtype)
    rc = fn(int(tau0.shape[0]), int(num_local),
            tau0.ctypes.data_as(ctypes.c_void_p),
            pi.ctypes.data_as(ctypes.c_void_p),
            pj.ctypes.data_as(ctypes.c_void_p),
            r.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise OSError("native sweep failed")
    return r


def sweep_batch(tau0, pi, pj, p_starts, v_starts) -> np.ndarray:
    """Independent per-row sweeps in one call.  Row b: pairs
    [p_starts[b], p_starts[b+1]) over a local vertex space of
    v_starts[b+1] - v_starts[b]; returns the concatenated radii."""
    lib = _lib()
    tau0, fn = _float(tau0, lib, "ge_sweep_batch")
    pi = np.ascontiguousarray(pi, dtype=np.int32)
    pj = np.ascontiguousarray(pj, dtype=np.int32)
    p_starts = np.ascontiguousarray(p_starts, dtype=np.int64)
    v_starts = np.ascontiguousarray(v_starts, dtype=np.int64)
    R = int(p_starts.shape[0]) - 1
    if v_starts.shape[0] != R + 1:
        raise ValueError("p_starts and v_starts describe different rows")
    r = np.empty(int(v_starts[-1]), dtype=tau0.dtype)
    rc = fn(R, p_starts.ctypes.data_as(ctypes.c_void_p),
            v_starts.ctypes.data_as(ctypes.c_void_p),
            tau0.ctypes.data_as(ctypes.c_void_p),
            pi.ctypes.data_as(ctypes.c_void_p),
            pj.ctypes.data_as(ctypes.c_void_p),
            r.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise OSError("native batched sweep failed")
    return r
