"""The port's radii device sweep (``radii_inner(backend="bucketed")``), the
native duplicate-summing COO sort behind ``from_coo``, against the JAX
package and the numpy paths they replace
(tests/test_embed.py:355-432, tests/test_native_pack.py)."""

import filecmp
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graph_embed_tpu as gt
import graph_embed_tpu.graph.csr as jcsr
from graph_embed_tpu.embed import radii as JR

from graph_embed_tpu_torch import interop
from graph_embed_tpu_torch.embed import radii as PR
from graph_embed_tpu_torch.graph import csr as pcsr
from graph_embed_tpu_torch.native import SRC_DIR, pack_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pairs(rng, S=40, frac=0.4):
    c = rng.uniform(-1, 1, size=(S, 3))
    iu, ju = np.triu_indices(S, k=1)
    keep = rng.random(iu.size) < frac
    pi, pj = iu[keep].astype(np.int32), ju[keep].astype(np.int32)
    return np.linalg.norm(c[pi] - c[pj], axis=1) / 2.0, pi, pj, S


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_sweeps_match_jax(rng, dtype):
    """The torch sweep (``_sweep_one``, the reference's fori sweep), the
    Python heap and the native heap give the JAX device sweep's radii bit
    for bit, also with exact duplicate times (tie-break by pair index;
    tests/test_embed.py:355-376)."""
    tau, pi, pj, S = _pairs(rng)
    for t in (tau, np.round(tau, 1)):
        t = t.astype(dtype)
        want = np.asarray(JR._sweep_one_jit(
            jnp.asarray(t), jnp.asarray(pi), jnp.asarray(pj),
            jnp.ones(pi.size, bool), S))
        got = PR._sweep_one(torch.from_numpy(t), torch.from_numpy(pi).long(),
                            torch.from_numpy(pj).long(),
                            torch.ones(pi.size, dtype=torch.bool), S)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(PR._sweep_host(t, pi, pj, S), want)
        np.testing.assert_array_equal(PR._sweep(t, pi, pj, S), want)


def _inner_case(rng, dtype, n=300, mc=14):
    """tests/test_embed.py:412-426: grandparents of random sizes over a
    random coarse graph, on both sides."""
    sizes = rng.multinomial(n - mc, np.ones(mc) / mc) + 1
    v2a = np.repeat(np.arange(mc), sizes).astype(np.int32)
    s = rng.integers(0, n, size=3000)
    r = rng.integers(0, n, size=3000)
    keep = s != r
    jd = jnp.float64 if dtype == np.float64 else jnp.float32
    cg = gt.from_edges(s[keep], r[keep], None, n=n, symmetrize=True,
                       dtype=jd)
    coords = rng.uniform(-1, 1, size=(n, 3)).astype(dtype)
    jargs = (jnp.asarray(coords), jnp.ones(mc, jd), None, cg,
             gt.Partition(jnp.asarray(v2a), mc))
    td = torch.float64 if dtype == np.float64 else torch.float32
    pargs = (torch.from_numpy(coords), torch.ones(mc, dtype=td),
             interop.graph(*cg.to_coo_numpy(), n, dtype=td),
             interop.partition(v2a, mc))
    return jargs, pargs


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_radii_inner_bucketed_matches_auto_and_jax(rng, dtype):
    """backend='bucketed' (the torch sweep over power-of-two pair-count
    classes) is bitwise backend='auto' (one native batched sweep) and the
    JAX bucketed radii, singleton inheritance and untouched-children
    fallbacks included (tests/test_embed.py:403-432)."""
    jargs, pargs = _inner_case(rng, dtype)
    want = np.asarray(JR.radii_inner(*jargs, backend="bucketed"))
    got = PR.radii_inner(*pargs, backend="bucketed")
    auto = PR.radii_inner(*pargs, backend="auto")
    assert got.dtype == auto.dtype == pargs[0].dtype
    assert torch.equal(got, auto)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="backend"):
        PR.radii_inner(*pargs, backend="device")


def test_radii_inner_host_sweep_bucket(rng, monkeypatch):
    """Grandparents over HOST_SWEEP_P pairs sweep on the host, one by one,
    with the same radii as the device classes (tests/test_embed.py:
    379-400)."""
    jargs, pargs = _inner_case(rng, np.float64, n=120, mc=4)
    want = PR.radii_inner(*pargs, backend="bucketed")
    monkeypatch.setattr(PR, "HOST_SWEEP_P", 4)
    monkeypatch.setattr(JR, "HOST_SWEEP_P", 4)
    got = PR.radii_inner(*pargs, backend="bucketed")
    assert torch.equal(got, want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JR.radii_inner(*jargs, backend="bucketed")))


def _numpy_dedup(s, r, w, n):
    """The numpy branch of the port's from_coo (graph/csr.py:_finish_coo)
    with its row pointers."""
    key = s * np.int64(n) + r
    order = np.argsort(key, kind="stable")
    key, s, r, w = key[order], s[order], r[order], w[order]
    uniq = np.empty(key.shape, dtype=bool)
    uniq[0] = True
    np.not_equal(key[1:], key[:-1], out=uniq[1:])
    seg = np.cumsum(uniq) - 1
    w = np.bincount(seg, weights=w)
    s, r = s[uniq], r[uniq]
    return s, r, w, np.concatenate([[0], np.cumsum(np.bincount(
        s, minlength=n))])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coo_dedup_bitwise(seed):
    """The native sort sums each duplicate run in input order: bitwise the
    numpy path, signed weights included (tests/test_native_pack.py:41)."""
    rng = np.random.default_rng(seed)
    n, m = 97, 4000
    s = rng.integers(0, n, size=m).astype(np.int64)
    r = rng.integers(0, n, size=m).astype(np.int64)
    w = rng.normal(size=m)
    got = pack_lib.coo_dedup(s, r, w, n)
    want = _numpy_dedup(s.copy(), r.copy(), w.copy(), n)
    for a, b in zip(got, want):
        assert a.tobytes() == b.astype(a.dtype).tobytes()
    # no duplicates, empty rows
    s, r = np.array([5, 5, 2, 9]), np.array([1, 0, 2, 9])
    w = np.array([1.5, 2.5, -3.0, 0.25])
    for a, b in zip(pack_lib.coo_dedup(s, r, w, 12),
                    _numpy_dedup(s, r, w, 12)):
        assert a.tobytes() == b.astype(a.dtype).tobytes()


def test_from_coo_native_matches_numpy_and_jax(monkeypatch):
    """from_coo above _NATIVE_MIN_EDGES takes the native sort, equal to a
    numpy-forced run and to the JAX from_coo (tests/test_native_pack.py:
    72-89)."""
    rng = np.random.default_rng(7)
    n, m = 3000, 80_000
    assert m >= pcsr._NATIVE_MIN_EDGES == jcsr._NATIVE_MIN_EDGES
    s, r = rng.integers(0, n, size=m), rng.integers(0, n, size=m)
    w = rng.normal(size=m)
    native = pcsr.from_coo(s, r, w, n=n, dtype=torch.float64)
    j = gt.from_coo(s, r, w, n=n, dtype=jnp.float64)
    monkeypatch.setattr(pcsr, "_NATIVE_MIN_EDGES", 1 << 60)
    numpy = pcsr.from_coo(s, r, w, n=n, dtype=torch.float64)
    for a, b, c in zip(native.host_coo, numpy.host_coo, j.to_coo_numpy()):
        assert a.tobytes() == b.tobytes()
        np.testing.assert_array_equal(a, c)
    assert torch.equal(native.indptr, numpy.indptr)
    np.testing.assert_array_equal(native.indptr.numpy(), np.asarray(j.indptr))


def test_pack_source_is_the_reference_copy():
    """The port builds coo_dedup from its own copy of pack.cpp, byte for
    byte the JAX package's."""
    assert filecmp.cmp(os.path.join(SRC_DIR, "pack.cpp"),
                       os.path.join(REPO, "graph_embed_tpu", "native",
                                    "pack.cpp"), shallow=False)
