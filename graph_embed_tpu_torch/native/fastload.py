"""ctypes binding of the native edge-list parser (``csrc/fastload.cpp``, a
copy of graph_embed_tpu/native/fastload.cpp), built on first use.  A build
failure raises; a file the parser refuses raises :class:`Refused`, and the
readers then parse it with numpy (graph/io.py)."""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from . import BUILD_DIR, SRC_DIR, build_shared

_LOCK = threading.Lock()
_LIB = None


class Refused(OSError):
    """The native parser could not read the file."""


def _lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build_shared(
                os.path.join(SRC_DIR, "fastload.cpp"),
                os.path.join(BUILD_DIR, "_fastload.so")))
            lib.fastload_parse.restype = ctypes.c_void_p
            lib.fastload_parse.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                           ctypes.POINTER(ctypes.c_int64)]
            lib.fastload_fill.restype = None
            lib.fastload_fill.argtypes = [ctypes.c_void_p] * 4
            lib.fastload_free.restype = None
            lib.fastload_free.argtypes = [ctypes.c_void_p]
            _LIB = lib
    return _LIB


def parse_edges(path, cols: int = 3):
    """Parse an edge-list file: (src int64[], dst int64[], w float64[] or
    None); ``cols=2`` ignores any weight column."""
    lib = _lib()
    count = ctypes.c_int64(0)
    handle = lib.fastload_parse(str(path).encode(), int(cols),
                                ctypes.byref(count))
    if count.value < 0 or handle is None:
        raise Refused(f"fastload: cannot parse {path}")
    m = count.value
    src = np.empty(m, dtype=np.int64)
    dst = np.empty(m, dtype=np.int64)
    w = np.empty(m, dtype=np.float64)
    lib.fastload_fill(handle, src.ctypes.data_as(ctypes.c_void_p),
                      dst.ctypes.data_as(ctypes.c_void_p),
                      w.ctypes.data_as(ctypes.c_void_p))
    lib.fastload_free(handle)
    return src, dst, (w if cols >= 3 else None)
