"""ctypes binding of the native one-sided greedy coarsener
(partitionBase / partitionBase2 semantics; ``csrc/greedy.cpp``, a copy of
graph_embed_tpu/native/greedy.cpp), built on first use."""

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
            lib = ctypes.CDLL(build_native("greedy"))
            lib.ge_greedy_run.restype = ctypes.c_int64
            lib.ge_greedy_run.argtypes = [
                ctypes.c_int64, ctypes.c_int64,           # n, e
                ctypes.c_void_p, ctypes.c_void_p,         # s, r
                ctypes.c_void_p, ctypes.c_int,            # w, is_f64
                ctypes.c_double, ctypes.c_int,            # stall, variant
                ctypes.c_void_p,                          # assign out [n]
                ctypes.POINTER(ctypes.c_double),          # Q out
            ]
            _LIB = lib
    return _LIB


def available() -> bool:
    try:
        _lib()
        return True
    except Exception:
        return False


def greedy_run(n, senders, receivers, weights, *, stall_stop_threshold=1.0,
               variant="base"):
    """Run the native greedy coarsener: (assign int32[n], M, Q)."""
    lib = _lib()
    s = np.ascontiguousarray(senders, dtype=np.int32)
    r = np.ascontiguousarray(receivers, dtype=np.int32)
    w = np.ascontiguousarray(weights)
    if w.dtype not in (np.float32, np.float64):
        w = w.astype(np.float64)
    is_f64 = int(w.dtype == np.float64)
    assign = np.empty(int(n), dtype=np.int32)
    q = ctypes.c_double(0.0)
    m = lib.ge_greedy_run(
        int(n), int(s.shape[0]),
        s.ctypes.data_as(ctypes.c_void_p), r.ctypes.data_as(ctypes.c_void_p),
        w.ctypes.data_as(ctypes.c_void_p), is_f64,
        float(stall_stop_threshold), int(variant == "base2"),
        assign.ctypes.data_as(ctypes.c_void_p), ctypes.byref(q))
    if m < 0:
        raise OSError("native greedy coarsener failed")
    return assign, int(m), float(q.value)
