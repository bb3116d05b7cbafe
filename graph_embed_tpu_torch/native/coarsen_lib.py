"""ctypes binding of the native mutual-best coarsener
(graph_embed_tpu/native/coarsen.cpp), built on first use."""

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
            lib = ctypes.CDLL(build_native("coarsen"))
            lib.ge_coarsen_run.restype = ctypes.c_void_p
            lib.ge_coarsen_run.argtypes = [
                ctypes.c_int64, ctypes.c_int64,              # n, e
                ctypes.c_void_p, ctypes.c_void_p,            # s, r
                ctypes.c_void_p, ctypes.c_int,               # w, is_f64
                ctypes.c_double, ctypes.c_int64,             # cf, num_parts
                ctypes.c_int, ctypes.c_int,                  # match_iters, pos
                ctypes.c_double, ctypes.c_int,               # stall, leaves
                ctypes.c_int, ctypes.c_double,               # hash_tb, jitter
                ctypes.c_int64, ctypes.c_double,             # max_agg, absorb
                ctypes.c_int64, ctypes.c_int,                # force_to, emit
                ctypes.POINTER(ctypes.c_int64),              # num_levels out
                ctypes.POINTER(ctypes.c_double),             # Q out
            ]
            lib.ge_coarsen_graph_edges.restype = ctypes.c_int64
            lib.ge_coarsen_graph_edges.argtypes = [ctypes.c_void_p,
                                                   ctypes.c_int64]
            lib.ge_coarsen_fill_graph.restype = None
            lib.ge_coarsen_fill_graph.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p]
            lib.ge_coarsen_level_sizes.restype = None
            lib.ge_coarsen_level_sizes.argtypes = [ctypes.c_void_p,
                                                   ctypes.c_void_p]
            lib.ge_coarsen_fill_assign.restype = None
            lib.ge_coarsen_fill_assign.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
            lib.ge_coarsen_free.restype = None
            lib.ge_coarsen_free.argtypes = [ctypes.c_void_p]
            _LIB = lib
    return _LIB


def coarsen_run(n, senders, receivers, weights, *, coarsening_factor=0.0,
                num_parts=0, matching_iterations=2, positive_merging=True,
                stall_stop_threshold=1.0, merge_leaves=False,
                tie_break="hash", weight_jitter=0.0, max_agg_size=0,
                absorb_below=0.0, force_coarsen_to=0, emit_graphs=False):
    """Run the native hierarchy coarsener.

    Returns (assignments, level_sizes, Q, graphs): ``assignments[l]`` maps
    level-l vertices to level-(l+1) aggregates (int32); ``level_sizes`` is
    [n0, ..., nk]; with ``emit_graphs`` ``graphs[l]`` is A_{l+1} = P^T A P
    as a canonical COO (s, r, w) sorted by (s, r) and deduplicated, else
    ``graphs`` is None."""
    lib = _lib()
    s = np.ascontiguousarray(senders, dtype=np.int32)
    r = np.ascontiguousarray(receivers, dtype=np.int32)
    w = np.ascontiguousarray(weights)
    if w.dtype not in (np.float32, np.float64):
        w = w.astype(np.float64)
    is_f64 = int(w.dtype == np.float64)
    num_levels = ctypes.c_int64(0)
    q = ctypes.c_double(0.0)
    handle = lib.ge_coarsen_run(
        int(n), int(s.shape[0]),
        s.ctypes.data_as(ctypes.c_void_p), r.ctypes.data_as(ctypes.c_void_p),
        w.ctypes.data_as(ctypes.c_void_p), is_f64,
        float(coarsening_factor), int(num_parts), int(matching_iterations),
        int(bool(positive_merging)), float(stall_stop_threshold),
        int(bool(merge_leaves)), int(tie_break == "hash"),
        float(weight_jitter), int(max_agg_size), float(absorb_below),
        int(force_coarsen_to), int(bool(emit_graphs)),
        ctypes.byref(num_levels), ctypes.byref(q))
    if not handle:
        raise OSError("native coarsener failed")
    try:
        k = num_levels.value
        sizes = np.empty(k + 1, dtype=np.int64)
        lib.ge_coarsen_level_sizes(handle,
                                   sizes.ctypes.data_as(ctypes.c_void_p))
        assignments = []
        for lvl in range(k):
            a = np.empty(int(sizes[lvl]), dtype=np.int32)
            lib.ge_coarsen_fill_assign(handle, lvl,
                                       a.ctypes.data_as(ctypes.c_void_p))
            assignments.append(a)
        if not emit_graphs:
            return assignments, sizes.tolist(), float(q.value), None
        graphs = []
        for lvl in range(k):
            e = int(lib.ge_coarsen_graph_edges(handle, lvl))
            cs = np.empty(e, dtype=np.int32)
            cr = np.empty(e, dtype=np.int32)
            cw = np.empty(e, dtype=np.float64)
            if e:
                lib.ge_coarsen_fill_graph(
                    handle, lvl, cs.ctypes.data_as(ctypes.c_void_p),
                    cr.ctypes.data_as(ctypes.c_void_p),
                    cw.ctypes.data_as(ctypes.c_void_p))
            graphs.append((cs, cr, cw))
        return assignments, sizes.tolist(), float(q.value), graphs
    finally:
        lib.ge_coarsen_free(handle)
