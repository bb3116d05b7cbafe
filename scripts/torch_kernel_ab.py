#!/usr/bin/env python3
"""Kernels A to F of two builds of ``graph_embed_tpu_torch/csrc`` on one
CUDA card, on the same inputs: this checkout's and another checkout's.

    python3 scripts/torch_kernel_ab.py --other DIR [--only A,B,C,D,E,F,flat]

DIR is the root of another checkout (a ``git archive`` of an earlier
commit, say; ``--other`` may repeat, and each DIR is then compared with
this checkout in turn, after a ``{"phase": "other"}`` line that names it).
Its ``graph_embed_tpu_torch/csrc`` is built with nvcc into a
temporary directory outside both checkouts and loaded beside this
checkout's library.  Its entry points may predate this checkout's: kernel
A's and E's without the hub list take no plan, a kernel B whose
``ge_bucket_tile()`` is 256 takes the table of one row per 256 slots
(cta start, S, bucket base, bucket end), built here for it, and a kernel F
without ``ge_ring_live_counts`` takes no live counts.  At the shapes
``chip_smoke.py`` gives each kernel it reports, one JSON line per
measurement:

  kernel    kernel A unit (the level-0 slot CSR of mesh3d(128), the
            residual CSRs of rmat(20, 8) and community_rmat(512, 22, 8)),
            weighted (the first Galerkin level), bf16x (community bf16,
            rmat(20, 8) ordered bf16),
            exact (community tiered nohubs), stream-only (community,
            rmat(20, 8)); kernel B (the level-0 and first Galerkin slot
            layouts of mesh3d(128), whole and one size class at a time);
            kernel C (rmat(20, 8) under linlog at 7, 64 and 300 samples);
            kernel D (mesh3d(128), rmat(20, 8), community f32; at 64
            samples and at one, the sample loop all but removed); kernel E
            (the linlog CSRs of rmat(20, 8) and of the community graph);
            kernel F (the halo rings of the community graph and the
            partition-ordered rmat(20, 8) at 8 shards: the eight slots'
            launches over a filled slot buffer, the whole ring with its
            forwards, then each slot's launch alone, with its live and
            padding entries):
            whether the two outputs are torch.equal, else the largest
            difference over the element's sum of |terms|; both builds'
            times on the card alone and the host's enqueue times
            (chip_smoke.device_ms), in the order other, this, this, other;
  halo_step with section F, the halo steps of its two rings, overlap and
            collective, in ms per iteration with either build's kernels
            (chip_smoke.halo_step_ms; the same order);
  flat      the flat step's ms per iteration on chip_smoke.py's nine plans
            with either build's kernels (median of 5 CUDA-event timings of
            20 iterations each; the same order).
``--only`` picks the sections (default all).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import ctypes
import dataclasses
import glob
import os
import shutil
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as CS  # noqa: E402


def entry_points(lib) -> dict:
    """What a library's entry points take: kernel A's and E's hub lists,
    kernel B's slots per table row, kernel F's live counts."""
    return dict(hubs=hasattr(lib, "ge_spmv_hub_row"),
                linlog_hubs=hasattr(lib, "ge_linlog_stage_floats"),
                bucket_tile=lib.ge_bucket_tile(),
                ring_live=hasattr(lib, "ge_ring_live_counts"))


def build_other(root: str, work: str):
    """nvcc the other checkout's csrc into ``work``; returns the loaded
    library and what its entry points take (``entry_points``)."""
    from graph_embed_tpu_torch.ops import cuda

    srcs = sorted(glob.glob(os.path.join(root, "graph_embed_tpu_torch",
                                         "csrc", "*.cu")))
    objs = [os.path.join(work, os.path.basename(s) + ".o") for s in srcs]
    procs = [subprocess.Popen([cuda._nvcc(), *cuda.COMPILE_FLAGS, "-c", "-o",
                               o, s], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for s, o in zip(srcs, objs)]
    for s, proc in zip(srcs, procs):
        out = proc.communicate()[0]
        CS.require(proc.returncode == 0, f"nvcc {s}: {out[-2000:]}")
    lib_path = os.path.join(work, "libother.so")
    link = subprocess.run([cuda._nvcc(), *cuda.ARCH_FLAGS, "-shared", "-o",
                           lib_path, *objs], capture_output=True, text=True)
    CS.require(link.returncode == 0, "link: " + link.stderr[-2000:])
    lib = ctypes.CDLL(lib_path)
    cuda.declare(lib)
    takes = entry_points(lib)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if not takes["hubs"]:
        lib.ge_edge_spmm.argtypes = [i, i, p, p, p, p, p, p]
        for fn in (lib.ge_edge_spmm_bf16x, lib.ge_edge_spmm_null):
            fn.argtypes = [i, i, p, p, p, p, p]
    if not takes["linlog_hubs"]:
        lib.ge_edge_linlog.argtypes = [i, i, p, p, p, p, p, f, f, p]
    if takes["bucket_tile"] == 256:
        lib.ge_bucket_repulsion.argtypes = [i, i, p, p, p, p, f, f, p]
    if not takes["ring_live"]:
        lib.ge_ring_attraction.argtypes = [i, i, i, i, i, p, p, p, p, p, p,
                                           p, f, f, f, i, i, i, p, p]
    return lib, takes


def _ring_liveless(lib):
    """Kernel F's ring launcher (``overlap._ring_launcher``) for a library
    whose entry point takes the slot's entry count (shards * ec) and every
    entry's mask, not live counts.  It runs this checkout's checks, so that
    both builds' host enqueue times include them."""
    from graph_embed_tpu_torch.ops import cuda
    from graph_embed_tpu_torch.parallel import overlap as OV

    def ring_launcher(x, deg_p1, ring, params, buf, out):
        ndev, ec, d = ring.ndev, ring.ec, x.shape[1]
        OV._check_operands(buf, x, deg_p1, (ring.cs, ring.cr, ring.cw),
                           ring.live, out, lead=(ndev,), ndev=ndev, ec=ec,
                           blk=ring.blk)
        fa, stream = OV._fa_args(params), cuda.stream_of(x)
        cs, cr, cw, mask, b, xp, dp, o = (t.data_ptr() for t in (
            ring.cs, ring.cr, ring.cw, ring.mask, buf, x, deg_p1, out))
        group, slot_in = 4 * ndev * ec, 4 * ndev * ring.b_max * d

        def launch(k: int) -> None:
            g = k * group
            rc = lib.ge_ring_attraction(
                ndev * ec, ec, d, ring.blk, ring.b_max, cs + g, cr + g,
                cw + g, mask + g, b + k * slot_in, xp, dp, *fa,
                o + k * group * d, stream)
            cuda.check(rc, "ring_attraction")
            cuda.LAUNCHES["ring_attraction"] += 1

        return launch

    return ring_launcher


def _linlog_planless(lib):
    """Kernel E's wrapper for a library whose entry point takes no hub
    list."""
    import torch

    from graph_embed_tpu_torch.ops import cuda

    def linlog_cuda(x, csr, *, attract, eps):
        out = torch.empty((csr.n_rows, x.shape[1]), dtype=torch.float32,
                          device=x.device)
        rc = lib.ge_edge_linlog(
            csr.n_rows, x.shape[1], csr.indptr.data_ptr(), csr.col.data_ptr(),
            csr.w.data_ptr(), x.data_ptr(), out.data_ptr(), float(attract),
            float(eps), cuda.stream_of(x))
        cuda.check(rc, "edge_linlog")
        return out

    return linlog_cuda


def cta_table_256(buckets):
    """The table of a kernel B that cuts 256 slots per row: (cta start, S,
    bucket base, bucket end) over the exact buckets."""
    import numpy as np

    rows = []
    for b in buckets:
        if b.sampled:
            continue
        end = b.base + b.m_b * b.S
        starts = np.arange(b.base, end, 256, dtype=np.int64)
        rows.append(np.stack([starts, np.full_like(starts, b.S),
                              np.full_like(starts, b.base),
                              np.full_like(starts, end)], axis=1))
    return np.concatenate(rows).astype(np.int32)


def _bucket_256(lib):
    """Kernel B's wrapper for a library that takes ``cta_table_256``: the
    table over the buckets of the classes the slot space's own table holds
    (so a table restricted to one class restricts this one too)."""
    import torch

    from graph_embed_tpu_torch.ops import cuda

    # by the space's own table, held so that its id stays its own; built
    # on the first call (which waits on the card), so timed calls do not
    tables = {}

    def slot_repulsion_cuda(x, w, space, repel, eps):
        key = id(space.tasks)
        if key not in tables:
            classes = set(space.tasks[:, 1].abs().tolist())
            tables[key] = (space.tasks, torch.from_numpy(cta_table_256(
                [b for b in space.buckets if b.S in classes])).to(x.device))
        meta = tables[key][1]
        out = torch.empty_like(x)
        rc = lib.ge_bucket_repulsion(
            meta.shape[0], x.shape[1], meta.data_ptr(), x.data_ptr(),
            w.data_ptr(), out.data_ptr(), float(repel), float(eps),
            cuda.stream_of(x))
        cuda.check(rc, "bucket_repulsion")
        return out

    return slot_repulsion_cuda


def _planless(lib):
    """Kernel A's three wrappers for a library whose entry points take no
    hub list: (spmv_cuda, spmv_bf16x_cuda, spmv_null_cuda)."""
    import torch

    from graph_embed_tpu_torch.ops import cuda

    def run(fn, name, x, csr, d, *data):
        y = torch.empty((csr.n_rows, d), dtype=torch.float32,
                        device=x.device)
        rc = fn(csr.n_rows, d, csr.indptr.data_ptr(), csr.col.data_ptr(),
                *data, y.data_ptr(), cuda.stream_of(x))
        cuda.check(rc, name)
        return y

    def spmv(x, csr):
        return run(lib.ge_edge_spmm, "edge_spmm", x, csr, x.shape[1],
                   None if csr.w is None else csr.w.data_ptr(), x.data_ptr())

    def bf16x(xp, csr, d):
        return run(lib.ge_edge_spmm_bf16x, "edge_spmm_bf16x", xp, csr, d,
                   xp.data_ptr())

    def null(x, csr):
        return run(lib.ge_edge_spmm_null, "edge_spmm_null", x, csr,
                   x.shape[1], x.data_ptr())

    return spmv, bf16x, null


@contextlib.contextmanager
def use(lib, takes: dict):
    """Route the port's kernel wrappers to ``lib`` inside the block."""
    from graph_embed_tpu_torch.ops import bucket_repulsion as BR
    from graph_embed_tpu_torch.ops import cuda
    from graph_embed_tpu_torch.ops import edge_spmm as ES
    from graph_embed_tpu_torch.parallel import overlap as OV

    patches = []
    if not takes["hubs"]:
        patches += zip([ES] * 3, ("spmv_cuda", "spmv_bf16x_cuda",
                                  "spmv_null_cuda"), _planless(lib))
    if not takes["linlog_hubs"]:
        patches.append((ES, "linlog_cuda", _linlog_planless(lib)))
    if takes["bucket_tile"] == 256 != cuda.BUCKET_TILE:
        patches.append((BR, "slot_repulsion_cuda", _bucket_256(lib)))
    if not takes["ring_live"]:
        patches.append((OV, "_ring_launcher", _ring_liveless(lib)))
    saved_lib = cuda._LIB
    saved = [(mod, n, getattr(mod, n)) for mod, n, _ in patches]
    cuda._LIB = lib
    for mod, n, fn in patches:
        setattr(mod, n, fn)
    try:
        yield
    finally:
        cuda._LIB = saved_lib
        for mod, n, fn in saved:
            setattr(mod, n, fn)


def paired(fn, this, other, reps: int = 20) -> dict:
    """``fn`` timed on the card alone and by host enqueue with each build,
    in the order other, this, this, other; the mean of each build's two."""
    runs = {"this": [], "other": []}
    for label in ("other", "this", "this", "other"):
        with use(*(other if label == "other" else this)):
            runs[label].append(CS.device_ms(fn, reps=reps))
    return {f"{k}_{m}": statistics.fmean(r[j] for r in v)
            for k, v in runs.items()
            for j, m in enumerate(("ms", "host_ms"))}


def compare(kernel: str, shape: str, fn, scale, this, other, *,
            select=None, **fields) -> None:
    """One kernel on one shape with both builds: equality, the largest
    difference over scale, both times.  ``select`` picks from ``fn``'s
    output what is compared (the times are ``fn``'s alone)."""
    import torch

    outs = {}
    for label, lib in (("this", this), ("other", other)):
        with use(*lib):
            outs[label] = fn() if select is None else select(fn())
    torch.cuda.synchronize()
    a, b = outs["this"], outs["other"]
    if not isinstance(a, tuple):
        a, b = (a,), (b,)
    equal = all(torch.equal(u, v) for u, v in zip(a, b))
    worst = max(CS.scaled_err(u, v, s)[1] for u, v, s in zip(a, b, scale))
    CS.emit(phase="kernel", kernel=kernel, shape=shape, equal=equal,
            max_diff_over_scale=worst, **fields,
            **paired(fn, this, other))


def spmv_cases(torch, dev, g, res, flat, lj):
    """(mode, shape, csr, x) for kernel A's modes."""
    from graph_embed_tpu_torch.forceatlas import multilevel_tiled as MT
    from graph_embed_tpu_torch.utils.params import MultilevelFAParams

    gen = torch.Generator(device=dev).manual_seed(1)
    cases = []
    for level, graph in ((0, g), (1, res.coarse_graphs[0])):
        layout = MT.prepare_refine(graph.to(dev), res.levels[level].to(dev),
                                   MultilevelFAParams())
        mode = "unit" if layout.csr.w is None else "weighted"
        cases.append((mode, f"level {level} slots", layout.csr))
    cases.append(("unit", "rmat(20,8)", flat["rmat(20,8)"][1].csr))
    cases.append(("unit", "community f32", lj["community f32"][1].csr))
    cases.append(("bf16x", "community bf16", lj["community bf16"][1].csr))
    cases.append(("bf16x", "rmat(20,8) ordered bf16",
                  lj["rmat(20,8) ordered bf16"][1].csr))
    cases.append(("exact", "community tiered nohubs",
                  lj["community tiered nohubs"][1].csr))
    cases.append(("vnull", "community bf16", lj["community bf16"][1].csr))
    cases.append(("vnull", "rmat(20,8)", flat["rmat(20,8)"][1].csr))
    out = []
    for mode, shape, csr in cases:
        x = torch.rand((csr.n_cols, 3), generator=gen, device=dev) * 2 - 1
        out.append((mode, shape, csr, x))
    return out


SECTIONS = ("A", "B", "C", "D", "E", "F", "flat")


def section_a(torch, dev, g, res, flat, lj, this, other) -> None:
    from graph_embed_tpu_torch.ops import edge_spmm as ES

    for mode, shape, csr, x in spmv_cases(torch, dev, g, res, flat, lj):
        wabs = csr if csr.w is None else dataclasses.replace(
            csr, w=csr.w.abs())
        if mode == "bf16x":
            xp = ES.pack_x_bf16(x)
            fn = lambda xp=xp, csr=csr: ES.spmv_bf16x_cuda(xp, csr, 3)
            scale = [ES.spmv_plain(ES.unpack_x_bf16(xp, 3).abs(), csr)]
        elif mode == "vnull":
            fn = lambda x=x, csr=csr: ES.spmv_null_cuda(x, csr)
            scale = [ES.spmv_plain(x.abs(), csr)]
        else:
            fn = lambda x=x, csr=csr: ES.spmv_cuda(x, csr)
            scale = [ES.spmv_plain(x.abs(), wabs)]
        compare(f"edge_spmm[{mode}]", shape, fn, scale, this, other,
                rows=csr.n_rows, nnz=csr.nnz,
                hubs=int(csr.hub_rows.shape[0]))


def section_b(torch, dev, g, res, this, other) -> None:
    """Kernel B on the level-0 and first Galerkin slot layouts, whole and
    one size class at a time (the table restricted to the class)."""
    from graph_embed_tpu_torch.forceatlas import multilevel_tiled as MT
    from graph_embed_tpu_torch.ops import bucket_repulsion as BR
    from graph_embed_tpu_torch.utils.params import MultilevelFAParams

    params = MultilevelFAParams()
    gen = torch.Generator(device=dev).manual_seed(1)
    for level, graph in ((0, g), (1, res.coarse_graphs[0])):
        layout = MT.prepare_refine(graph.to(dev), res.levels[level].to(dev),
                                   params)
        w = layout.w_rep
        x = torch.rand((layout.n_slots, 3), generator=gen, device=dev) * 2 - 1
        x = torch.where(layout.valid_slot[:, None], x, torch.zeros_like(x))
        scale = BR.slot_repulsion_plain(x, w, layout.space, params.repel,
                                        params.epsilon, absolute=True)
        exact = [b for b in layout.space.buckets if not b.sampled]
        # (shape, slot space, the buckets its table covers: the other slots
        # are left unwritten), with per-class counts at level 0
        tables = [(f"level {level} slots", layout.space, exact, {})]
        tables += [(f"level {level} class S={b.S}",
                    CS.class_table(layout.space, b.S), [b],
                    CS.b_class_counts(b))
                   for b in exact]
        for shape, space, mine, counts in tables:
            # looked up on the module at each call, so ``use`` reroutes it
            compare("bucket_repulsion", shape,
                    lambda space=space, x=x: BR.slot_repulsion_cuda(
                        x, w, space, params.repel, params.epsilon),
                    [torch.cat([scale[b.slots] for b in mine])], this, other,
                    select=lambda out, mine=mine: torch.cat(
                        [out[b.slots] for b in mine]),
                    table_rows=int(space.tasks.shape[0]), **counts)


def section_c(torch, dev, flat, this, other) -> None:
    """Kernel C on the rmat graph's linlog plan at chip_smoke's sample
    counts."""
    from graph_embed_tpu_torch.ops import repulsion as RP

    g, tfa, _ = flat["rmat(20,8) linlog"]
    params = CS.flat_params(linlog=True)
    kw = dict(repel=params.repel, eps=params.epsilon)
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.rand((g.n, 3), generator=gen, device=dev) * 2 - 1
    for s in CS.C_SAMPLES:
        idx = RP.draw_samples(g.n, s, gen, dev)
        scale = [RP.repulsion_sampled_plain(x, tfa.deg_p1, idx,
                                            absolute=True, **kw)]
        compare("sampled_repulsion", "rmat(20,8)",
                lambda idx=idx: RP.repulsion_sampled_cuda(
                    x, tfa.deg_p1, idx, **kw), scale, this, other, n=g.n,
                samples=s)


def ring_cases(torch, dev, graphs) -> list:
    """Kernel F's inputs on the halo rings of chip_smoke's halo phase (8
    shards): (shape, plan, ring, deg + 1, x, filled slot buffer, the plain
    per-edge forces, (overlap step, collective step))."""
    from graph_embed_tpu_torch.parallel import overlap as OV

    params = CS.flat_params()
    gen = torch.Generator(device=dev).manual_seed(11)
    cases = []
    for shape, g in zip(("community", "rmat(20,8) ordered"), graphs):
        plan, ov, col, _ = CS.halo_steps(torch, g, dev)
        x = torch.zeros((plan.ndev * plan.blk, 3), device=dev)
        x[: g.n] = torch.rand((g.n, 3), generator=gen, device=dev) * 2 - 1
        cases.append((shape, plan, ov.ring, ov.deg_p1, x,
                      CS.filled_slots(torch, x, plan, ov.ring),
                      OV.ring_cross_forces_plain(x, ov.deg_p1, ov.ring,
                                                 params), (ov, col)))
    return cases


def section_f(torch, cases, this, other) -> None:
    """Kernel F on ``ring_cases``: its eight launches over the filled slot
    buffer (the operands checked once), the whole ring with its forwards,
    each slot alone, then the halo steps' ms per iteration."""
    from graph_embed_tpu_torch.parallel import overlap as OV

    params = CS.flat_params()
    for shape, plan, ring, deg_p1, x, buf, want, steps in cases:
        live = ring.live.sum(dim=1).tolist()
        compare("ring_attraction", shape,
                lambda buf=buf, x=x, deg_p1=deg_p1, ring=ring:
                OV.ring_slot_forces(buf, x, deg_p1, ring, params),
                [want.abs()], this, other, slot="all",
                entries=ring.cs.numel(), live=ring.live_edges,
                **CS.ring_bound(ring, plan, params))
        # the whole ring: the gather, the forwards on the side stream (each
        # slot's block written just before kernel F reads it) and F
        compare("ring_attraction", shape,
                lambda x=x, deg_p1=deg_p1, ring=ring:
                OV.ring_cross_forces(x, deg_p1, ring, params),
                [want.abs()], this, other, slot="ring")
        for k in range(plan.ndev):
            compare("ring_attraction", shape,
                    lambda buf=buf, x=x, deg_p1=deg_p1, ring=ring, k=k:
                    OV.ring_slot_forces(buf, x, deg_p1, ring, params,
                                        slots=(k,)),
                    [want[k].abs()], this, other,
                    select=lambda out, k=k: out[k], slot=k, live=live[k],
                    padding=plan.ndev * ring.ec - live[k])
        # the halo steps with each build's kernels, by events as
        # chip_smoke's halo phase times them; the collective step runs no
        # kernel F, so its two builds' times show the spread
        gen = torch.Generator(device=x.device).manual_seed(5)
        for label, step in zip(("overlap", "collective"), steps):
            runs = {"this": [], "other": []}
            for build in ("other", "this", "this", "other"):
                with use(*(other if build == "other" else this)):
                    runs[build].append(CS.halo_step_ms(
                        torch, step, x, lambda step=step: step.draw(gen)))
            CS.emit(phase="halo_step", shape=shape, step=label,
                    this_ms_per_iteration=statistics.fmean(runs["this"]),
                    other_ms_per_iteration=statistics.fmean(runs["other"]),
                    runs=runs)


def section_d(torch, dev, flat, lj, this, other) -> None:
    from graph_embed_tpu_torch.ops import edge_spmm as ES
    from graph_embed_tpu_torch.ops import fused_step as FS
    from graph_embed_tpu_torch.ops import repulsion as RP

    gen = torch.Generator(device=dev).manual_seed(2)
    plans = [(n, *flat[n][:2]) for n in (f"mesh3d({CS.MESH_SIDE})",
                                         "rmat(20,8)")]
    plans.append(("community f32", *lj["community f32"][:2]))
    for shape, graph, tfa in plans:
        params = CS.flat_params()
        x = torch.rand((graph.n, 3), generator=gen, device=dev) * 2 - 1
        fprev = torch.rand((graph.n, 3), generator=gen, device=dev) * 2 - 1
        y_res = None if tfa.csr is None else ES.spmv_cuda(x, tfa.csr)
        # the flat step's samples, and one sample: the step with its
        # sample loop all but removed
        for s in (CS.FLAT_SAMPLES, 1):
            idx = RP.draw_samples(graph.n, s, gen, dev)
            rest = (tfa.deg_w_att, tfa.deg_p1, idx, params)
            fn = (lambda x=x, fprev=fprev, tfa=tfa, y_res=y_res,
                  rest=rest: FS.fa_step_fused_cuda(
                      x, fprev, tfa.dia_w, tfa.dia_off, y_res, *rest))
            plain = (x, tfa.dia_w, tfa.dia_offsets, y_res, *rest)
            f_scale = FS.step_forces_plain(*plain, absolute=True)
            x_scale = x.abs() + f_scale  # x' = x + f * speed, speed <= 1
            compare("fused_step", shape, fn, [x_scale, f_scale], this,
                    other, n=graph.n, samples=s,
                    dia_offsets=len(tfa.dia_offsets))


def section_e(torch, dev, flat, lj, this, other) -> None:
    """Kernel E on the rmat graph's linlog plan and a linlog plan of the
    community graph (rows of ~14 entries: the thread-per-row path)."""
    from graph_embed_tpu_torch.forceatlas import tiled as TL
    from graph_embed_tpu_torch.ops import edge_spmm as ES

    params = CS.flat_params(linlog=True)
    kw = dict(attract=params.attract, eps=params.epsilon)
    gen = torch.Generator(device=dev).manual_seed(4)
    cg = lj["community f32"][0]
    for shape, csr in (("rmat(20,8)", flat["rmat(20,8) linlog"][1].csr),
                       ("community", TL.prepare_tiled(cg, 3, params).csr)):
        x = torch.rand((csr.n_cols, 3), generator=gen, device=dev) * 2 - 1
        scale = [ES.linlog_plain(x, csr, absolute=True, **kw)]
        compare("edge_linlog", shape,
                lambda x=x, csr=csr: ES.linlog_cuda(x, csr, **kw), scale,
                this, other, rows=csr.n_rows, nnz=csr.nnz,
                hubs=int(csr.hub_rows.shape[0]))


def section_flat(torch, dev, flat, lj, this, other) -> None:
    for name, (graph, tfa, params) in (
            [(n, (v[0], v[1], CS.flat_params(linlog="linlog" in n)))
             for n, v in flat.items()]
            + [(n, (v[0], v[1], v[2])) for n, v in lj.items()]):
        times = {"this": [], "other": []}
        for label in ("other", "this", "this", "other"):
            with use(*(other if label == "other" else this)):
                CS.drive_steps(torch, tfa, params, dev, 2)   # warm-up
                torch.cuda.synchronize()
                per = []
                for rep in range(CS.FLAT_REPEATS):
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    CS.drive_steps(torch, tfa, params, dev, CS.FLAT_ITERS,
                                   seed=rep)
                    b.record()
                    b.synchronize()
                    per.append(a.elapsed_time(b) / CS.FLAT_ITERS)
                times[label].append(statistics.median(per))
        CS.emit(phase="flat", plan=name, n=graph.n,
                stored_entries=graph.num_edges,
                this_ms_per_iteration=statistics.fmean(times["this"]),
                other_ms_per_iteration=statistics.fmean(times["other"]),
                runs=times)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, action="append",
                    help="root of the other checkout (repeat for several: "
                    "each is compared with this one in turn)")
    ap.add_argument("--only", default=",".join(SECTIONS),
                    help="comma-separated sections of " + ",".join(SECTIONS))
    args = ap.parse_args()
    only = set(args.only.split(","))
    if not only <= set(SECTIONS):
        ap.error(f"unknown sections {sorted(only - set(SECTIONS))}")
    if not torch.cuda.is_available():
        print("torch_kernel_ab: needs a CUDA device", file=sys.stderr)
        return 1
    import graph_embed_tpu_torch as gp
    from graph_embed_tpu_torch.graph import synth
    from graph_embed_tpu_torch.ops import cuda

    dev = torch.device("cuda", 0)
    CS.phase_env(torch)
    work = tempfile.mkdtemp(prefix="kernel_ab_")
    try:
        this = (cuda.library(), entry_points(cuda.library()))
        dirs = [os.path.join(work, str(i)) for i in range(len(args.other))]
        for d in dirs:
            os.makedirs(d)
        with concurrent.futures.ThreadPoolExecutor(len(dirs)) as pool:
            others = list(pool.map(build_other, [os.path.abspath(o) for o
                                                 in args.other], dirs))
        for path, other in zip(args.other, others):
            CS.emit(phase="build", other=path, other_takes=other[1],
                    this_takes=this[1])

        # build only what the sections take
        g = res = flat = lj = graphs = rings = None
        if only & {"A", "B", "D", "flat"}:
            g = synth.mesh3d(CS.MESH_SIDE)
        if only & {"A", "B"}:
            res = gp.partition_hierarchy(g, 0.1, emit_graphs=True)
        if only & {"A", "C", "D", "E", "flat"}:
            flat = CS.setup_flat(dev, g)
        if only & {"A", "D", "E", "F", "flat"}:
            graphs = CS.lj_graphs(dev)
        if only & {"A", "D", "E", "flat"}:
            lj = CS.setup_lj(dev, graphs)
        if "F" in only:
            rings = ring_cases(torch, dev, graphs)
        for path, other in zip(args.other, others):
            # the lines that follow compare this build with ``path``'s
            CS.emit(phase="other", other=path)
            if "A" in only:
                section_a(torch, dev, g, res, flat, lj, this, other)
            if "B" in only:
                section_b(torch, dev, g, res, this, other)
            if "C" in only:
                section_c(torch, dev, flat, this, other)
            if "D" in only:
                section_d(torch, dev, flat, lj, this, other)
            if "E" in only:
                section_e(torch, dev, flat, lj, this, other)
            if "F" in only:
                section_f(torch, rings, this, other)
            if "flat" in only:
                section_flat(torch, dev, flat, lj, this, other)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
