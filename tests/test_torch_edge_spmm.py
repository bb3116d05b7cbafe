"""Kernel A's plain version against the JAX windowed SpMV (Pallas interpret
mode) on the refinement's slot tilings (kernel A itself is held to its
plain version on the card by tests/test_torch_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graph_embed_tpu as gt
from graph_embed_tpu.forceatlas import multilevel_tiled as jmlt
from graph_embed_tpu.ops.pallas import edge_spmm as JES
from graph_embed_tpu.utils.params import MultilevelFAParams

from graph_embed_tpu_torch.forceatlas import forces as pforces
from graph_embed_tpu_torch.ops import edge_spmm as PES


def _level(rng, weighted, n=300, m=24):
    s = rng.integers(0, n, 4 * n)
    r = rng.integers(0, n, 4 * n)
    # distinct undirected pairs: duplicates would sum to weight 2
    pairs = np.unique(np.stack([np.minimum(s, r), np.maximum(s, r)]), axis=1)
    s, r = pairs[:, pairs[0] != pairs[1]]
    w = rng.uniform(0.5, 2.0, s.size) if weighted else None
    g = gt.from_edges(s, r, w, n=n, symmetrize=True, dtype=jnp.float32)
    v2a = rng.integers(0, m, n).astype(np.int32)
    v2a[:m] = np.arange(m)
    return g, gt.Partition.from_numpy(v2a, m), v2a


def _slot_coo(g, v2a, slot_of_vertex, params):
    """The intra-aggregate COO in JAX's slot space, folded as
    prepare_refine folds it (multilevel_tiled.py:199-215)."""
    s, r, w = g.to_coo_numpy()
    both = v2a[s] == v2a[r]
    intra = both & (s != r)
    deg = np.zeros(g.n)
    np.add.at(deg, s[both], w[both])
    folded = pforces.fold_edge_weights(w, deg[s], use_weights=True,
                                       delta=params.delta,
                                       nohubs=params.nohubs)[intra]
    return slot_of_vertex[s[intra]], slot_of_vertex[r[intra]], folded


@pytest.mark.parametrize("weighted", [False, True])
def test_plain_spmv_matches_windowed(rng, weighted):
    """Same slot-space COO through both: JAX's tiling (unit packing, or
    bf16-truncated weights) and the port's CSR.  rtol 2e-4 is the class of
    tests/test_edge_spmm.py:34: the TPU scatter's bf16 hi/lo split leaves
    ~2^-16 relative error that an exact float32 sum does not have."""
    params = MultilevelFAParams()
    g, part, v2a = _level(rng, weighted)
    layout = jmlt.prepare_refine(g, part, params)
    assert layout.tiles.packing == ("bf16" if weighted else "unit")
    assert layout.tiles.num_overflow == 0
    slot = np.asarray(layout.slot_of_vertex).astype(np.int64)
    ss, rr, fw = _slot_coo(g, v2a, slot, params)
    n_slots = layout.n_slots
    csr, deg_w = PES.build_csr(
        ss, rr, PES.truncate_bf16(fw) if weighted else None, n_slots)
    assert (csr.w is None) == (not weighted)
    # row sums equal tiled_row_sums exactly (no overflow edges)
    np.testing.assert_array_equal(deg_w.numpy(),
                                  np.asarray(layout.deg_w_att)[:n_slots])

    x = rng.uniform(-1, 1, (n_slots, 3)).astype(np.float32)
    xT = JES.pad_coords_T(jnp.asarray(x), layout.tiles.n_pad)
    want = np.asarray(JES.spmv_windowed(xT, layout.tiles, interpret=True,
                                        dmax=4))[:3, :n_slots].T
    got = PES.spmv(torch.from_numpy(x), csr).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    att = PES.attraction_spmv(torch.from_numpy(x), csr, deg_w,
                              attract=1.3).numpy()
    want_att = np.asarray(JES.attraction_spmv(
        xT, layout.tiles, layout.deg_w_att, attract=1.3, interpret=True,
        dmax=4))[:3, :n_slots].T
    np.testing.assert_allclose(att, want_att, rtol=2e-4, atol=2e-5)


def test_truncate_bf16_is_toward_zero():
    w = np.array([1.0, 1.00390625 * 1.5, -2.7, 3.1e-5, 0.0], np.float32)
    got = PES.truncate_bf16(w)
    bits = got.view(np.int32)
    assert np.all(bits & 0xFFFF == 0)
    assert np.all(np.abs(got) <= np.abs(w))
    # rounding to nearest differs: 2.7 rounds up to 2.703125 in bf16
    assert got[2] == np.float32(-2.6875)
    assert torch.tensor(w[2]).to(torch.bfloat16).float().item() != got[2]


def test_spmv_rejects_other_devices():
    csr, _ = PES.build_csr(np.array([0, 1]), np.array([1, 0]), None, 2)
    with pytest.raises(ValueError):
        PES.spmv(torch.zeros((2, 3), device="meta"), csr)

