"""ctypes binding of the native duplicate-summing COO sort
(``csrc/pack.cpp``, a copy of graph_embed_tpu/native/pack.cpp), built on
first use.

``coo_dedup`` is ``graph.csr.from_coo``'s sum of duplicates with the CSR
row pointers (the linalgcpp ``CooMatrix::ToSparse`` role, embed.cpp:51-66):
a stable radix sort by (sender, receiver), each duplicate run summed in
float64 in its input order, bit-identical to the numpy sort it replaces.
The source's tile packer (``ge_pack_tiles``) is TPU layout and is not
bound.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from . import build_native

_LOCK = threading.Lock()
_LIB = None

_i64 = ctypes.c_int64
_p = ctypes.c_void_p


def _lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build_native("pack"))
            lib.ge_coo_dedup.restype = _p
            lib.ge_coo_dedup.argtypes = [_i64, _i64, _p, _p, _p,
                                         ctypes.POINTER(_i64)]
            lib.ge_coo_fill.restype = None
            lib.ge_coo_fill.argtypes = [_p, _p, _p, _p, _p]
            lib.ge_coo_free.restype = None
            lib.ge_coo_free.argtypes = [_p]
            _LIB = lib
    return _LIB


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_p)


def coo_dedup(s, r, w, n: int):
    """Sum duplicate (s, r) entries and build the CSR row pointers.

    Returns (s, r, w, indptr): s and r int64 sorted by (s, r), w float64
    with each duplicate run summed in its input order, indptr int64
    [n + 1]."""
    lib = _lib()
    s = np.ascontiguousarray(s, dtype=np.int64)
    r = np.ascontiguousarray(r, dtype=np.int64)
    w = np.ascontiguousarray(w, dtype=np.float64)
    count = _i64(0)
    handle = lib.ge_coo_dedup(s.size, int(n), _ptr(s), _ptr(r), _ptr(w),
                              ctypes.byref(count))
    if not handle:
        raise OSError("native coo_dedup failed")
    try:
        e = count.value
        so = np.empty(e, dtype=np.int64)
        ro = np.empty(e, dtype=np.int64)
        wo = np.empty(e, dtype=np.float64)
        indptr = np.empty(int(n) + 1, dtype=np.int64)
        lib.ge_coo_fill(handle, _ptr(so), _ptr(ro), _ptr(wo), _ptr(indptr))
    finally:
        lib.ge_coo_free(handle)
    return so, ro, wo, indptr
