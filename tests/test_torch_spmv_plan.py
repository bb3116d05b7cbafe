"""Kernel A's plan (``EdgeCSR.hub_rows``) and the schedule of its walk, on
the CPU.

Kernel A (csrc/edge_spmm.cu) sums every row in the tile block of its
TILE_ROWS consecutive rows, whole, by its own thread or its warp, except
the hub rows of more than ``cuda.SPMV_HUB_ROW`` entries, which the CSR
lists when it is built and which get a block each that gathers them CHUNK
entries at a time.  ``walk_schedule`` below restates that split, so the
properties the kernel relies on can be checked without the card: every
entry taken once, each row's entries in CSR order by one block, each
hub's cuts measured from the row's own start.  The plain version of the
walk is held to the JAX package's segment sum.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_embed_tpu.ops import segment as JSEG

from graph_embed_tpu_torch.ops import cuda
from graph_embed_tpu_torch.ops import edge_spmm as ES
from graph_embed_tpu_torch.ops import segment

HUB = cuda.SPMV_HUB_ROW
CHUNK = HUB          # csrc/edge_spmm.cu: HUB_ROW = CHUNK, a hub's pass
TILE_ROWS = 256      # csrc/edge_spmm.cu: TILE_ROWS

PROFILES = {
    "empty": [],
    "one empty row": [0],
    "short rows": [0, 1, 5, 31, 32, 0, 17],
    "at the threshold": [HUB - 1, HUB, HUB + 1, 0, HUB + 1],
    "hubs back to back": [3, HUB + 1, 3 * HUB + 17, HUB + 5, 2],
    "mixed": [(0, 5, 31, 33, 100, HUB, HUB + 1, 4 * HUB)[i % 8]
              for i in range(300)],
}


def _indptr(lengths) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(np.asarray(lengths, np.int64))
                           ]).astype(np.int32)


def _coo(lengths, rng, n_cols=500):
    lengths = np.asarray(lengths, np.int64)
    rows = np.repeat(np.arange(lengths.size), lengths)
    return rows, rng.integers(0, n_cols, rows.size), n_cols


def walk_schedule(indptr: np.ndarray, hub_rows: np.ndarray):
    """The kernel's pieces of work as [(block, start, end)] entry ranges:
    hub blocks first (one per listed hub, its chunks from the row's start),
    then the tile blocks, each taking its other rows whole."""
    n_rows = indptr.size - 1
    passes = []
    for b, r in enumerate(hub_rows):
        lo, hi = int(indptr[r]), int(indptr[r + 1])
        for c0 in range(lo, hi, CHUNK):
            passes.append((b, c0, min(c0 + CHUNK, hi)))
    for r in range(n_rows):
        lo, hi = int(indptr[r]), int(indptr[r + 1])
        if hi - lo > HUB:
            assert r in hub_rows
        elif hi > lo:
            passes.append((len(hub_rows) + r // TILE_ROWS, lo, hi))
    return passes


@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_hub_rows_are_the_rows_longer_than_a_chunk(rng, profile):
    lengths = PROFILES[profile]
    rows, cols, n_cols = _coo(lengths, rng)
    csr, _ = ES.build_csr(rows, cols, None, len(lengths), n_cols)
    want = [i for i, n in enumerate(lengths) if n > HUB]
    assert csr.hub_rows.dtype == torch.int32
    assert csr.hub_rows.tolist() == want


@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_hub_rows_alike_from_host_and_device_builds(rng, profile):
    """``build_csr`` plans from its host row pointers, ``sorted_csr`` from
    the tensor it is given (device row pointers on the card), the segment
    CSR through ``build_csr``: one list."""
    lengths = PROFILES[profile]
    rows, cols, n_cols = _coo(lengths, rng)
    host, _ = ES.build_csr(rows, cols, None, len(lengths), n_cols)
    seg = segment.sorted_csr(torch.from_numpy(_indptr(lengths)), rows.size)
    by_seg = segment.segment_csr(rows, len(lengths))
    assert torch.equal(seg.hub_rows, host.hub_rows)
    assert torch.equal(by_seg.hub_rows, host.hub_rows)
    # replacing the weights keeps the plan (it depends on indptr alone)
    w = torch.ones(rows.size)
    assert dataclasses.replace(host, w=w).hub_rows is host.hub_rows


@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_walk_takes_every_entry_once_in_order(rng, profile):
    """Every stored entry is taken by exactly one piece; a row's entries
    are taken in CSR order by one block; a hub's cuts lie at multiples of
    CHUNK from its own start, and any other row is one piece."""
    lengths = PROFILES[profile]
    indptr = _indptr(lengths)
    csr = segment.sorted_csr(torch.from_numpy(indptr), int(indptr[-1]))
    passes = walk_schedule(indptr, csr.hub_rows.numpy())
    seen = np.zeros(int(indptr[-1]), np.int64)
    for _, c0, c1 in passes:
        assert 0 < c1 - c0 <= CHUNK
        seen[c0:c1] += 1
    assert np.all(seen == 1)
    for r, n in enumerate(lengths):
        lo, hi = int(indptr[r]), int(indptr[r + 1])
        mine = [(b, max(c0, lo), min(c1, hi)) for b, c0, c1 in passes
                if c0 < hi and c1 > lo]
        assert len({b for b, _, _ in mine}) <= 1
        starts = [s for _, s, _ in mine]
        assert starts == sorted(starts)
        if n > HUB:
            assert all((s - lo) % CHUNK == 0 for s in starts)
        else:
            assert len(mine) == (1 if n else 0)


def test_hub_rows_do_not_depend_on_where_rows_start(rng):
    """Prepending rows shifts the hub ids and adds the new hubs: a row's
    class depends on its length alone."""
    tail = PROFILES["mixed"]
    head = [int(v) for v in rng.integers(0, 50, 77)]
    head[10] = HUB + 3
    a = segment.sorted_csr(torch.from_numpy(_indptr(tail)), sum(tail))
    b = segment.sorted_csr(torch.from_numpy(_indptr(head + tail)),
                           sum(head + tail))
    assert b.hub_rows.tolist() == [10] + [r + 77 for r in a.hub_rows.tolist()]


@pytest.mark.parametrize("d", [1, 3])
def test_plain_walk_matches_jax_segment_sum(rng, d):
    """The port's segment sum over a CSR with hubs (the plain version on
    the CPU) against the JAX package's segment_sum of the same values."""
    lengths = PROFILES["mixed"][:40]
    seg = np.repeat(np.arange(len(lengths)), lengths)
    vals = rng.uniform(-1, 1, (seg.size, d)).astype(np.float32)
    csr = segment.segment_csr(seg, len(lengths))
    assert csr.hub_rows.numel() > 0
    got = segment.segment_sum(torch.from_numpy(vals), csr).numpy()
    want = np.asarray(JSEG.segment_sum(jnp.asarray(vals), jnp.asarray(seg),
                                       len(lengths)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


# Kernel E (linlog attraction, csrc/edge_spmm.cu) walks the CSR as kernel
# A does: a row of at most LONG_ROW entries by its thread, a longer one of
# at most HUB entries by its warp (lane l takes entries l, l + 32, ...),
# a hub by a block whose warp 0 adds each staged CHUNK under the same lane
# rule.  Its sums are bitwise the parent's thread/warp walk only if a hub's
# lane sequences are the warp walk's.

LONG_ROW = 32        # csrc/edge_spmm.cu: LONG_ROW


def lane_sequences(lo: int, hi: int, chunked: bool):
    """Each lane's entries of the row [lo, hi), in the order the lane adds
    them: the warp walk, or a hub's CHUNK passes from the row's start."""
    seqs = [[] for _ in range(32)]
    cuts = range(lo, hi, CHUNK) if chunked else [lo]
    for c0 in cuts:
        c1 = min(c0 + CHUNK, hi) if chunked else hi
        for lane in range(32):
            seqs[lane] += list(range(c0 + lane, c1, 32))
    return seqs


@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_linlog_classes_take_every_entry_once_in_order(rng, profile):
    """E's three classes (thread, warp, hub) cover every row once by its
    length alone, the thread rows in CSR order; a warp or hub row's lanes
    together take every entry once, each lane in ascending order, and a
    hub's passes (cut at multiples of CHUNK from its own start) give every
    lane the warp walk's sequence."""
    lengths = PROFILES[profile]
    indptr = _indptr(lengths)
    csr = segment.sorted_csr(torch.from_numpy(indptr), int(indptr[-1]))
    hubs = set(csr.hub_rows.tolist())
    for r, n in enumerate(lengths):
        lo, hi = int(indptr[r]), int(indptr[r + 1])
        cls = ("thread" if n <= LONG_ROW else "warp" if n <= HUB
               else "hub")
        assert (cls == "hub") == (r in hubs)
        if cls == "thread":
            continue
        seqs = lane_sequences(lo, hi, chunked=cls == "hub")
        taken = sorted(e for s in seqs for e in s)
        assert taken == list(range(lo, hi))
        assert all(s == sorted(s) for s in seqs)
        assert seqs == lane_sequences(lo, hi, chunked=False)


def _star_graph(n=3000, extra=4000, seed=3):
    """A hub joined to every other vertex (a row of n - 1 > HUB entries)
    plus random weighted edges."""
    from graph_embed_tpu_torch import interop

    r = np.random.default_rng(seed)
    s = np.concatenate([np.zeros(n - 1, np.int64), r.integers(1, n, extra)])
    t = np.concatenate([np.arange(1, n), r.integers(1, n, extra)])
    keep = s != t
    s, t = s[keep], t[keep]
    w = r.uniform(0.5, 2.0, s.size)
    ss, tt = np.concatenate([s, t]), np.concatenate([t, s])
    order = np.lexsort((tt, ss))
    return interop.graph(ss[order], tt[order], np.concatenate([w, w])[order],
                         n)


def test_linlog_csrs_carry_the_hub_list():
    """The linlog CSRs kernel E runs on (the flat step's and the halo
    step's over [x | pool]) carry kernel A's hub list, planned from their
    own row pointers."""
    from graph_embed_tpu_torch.forceatlas import tiled as TL
    from graph_embed_tpu_torch.parallel import halo as PH
    from graph_embed_tpu_torch.utils.params import ForceAtlasParams

    g = _star_graph()
    params = ForceAtlasParams(repulsion="sampled", linlog=True)
    csrs = [TL.prepare_tiled(g, 3, params).csr]
    plan = PH.build_halo_plan(g, 2)
    csrs.append(PH.build_halo_csr(plan, params).csr)
    for csr in csrs:
        assert csr.w is not None and csr.n_rows <= csr.n_cols
        assert csr.hub_rows.tolist() == ES.plan_hub_rows(csr.indptr).tolist()
        assert csr.hub_rows.numel() == 1
