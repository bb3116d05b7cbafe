#!/usr/bin/env python3
"""Kernels A and D of two builds of ``graph_embed_tpu_torch/csrc`` on one
CUDA card, on the same inputs: this checkout's and another checkout's.

    python3 scripts/torch_kernel_ab.py --other DIR

DIR is the root of another checkout (a ``git archive`` of an earlier
commit, say).  Its ``graph_embed_tpu_torch/csrc`` is built with nvcc into a
temporary directory outside both checkouts and loaded beside this
checkout's library; its kernel A entry points may predate the hub list
(they then take no plan).  At the shapes ``chip_smoke.py`` gives each
kernel it reports, one JSON line per measurement:

  kernel    kernel A unit (the level-0 slot CSR of mesh3d(128), the
            residual CSRs of rmat(20, 8) and community_rmat(512, 22, 8)),
            weighted (the first Galerkin level), bf16x (community bf16),
            exact (community tiered nohubs), stream-only (community,
            rmat(20, 8)), and
            kernel D (mesh3d(128), rmat(20, 8), community f32; at 64
            samples and at one, the sample loop all but removed): whether
            the two outputs are torch.equal, else the largest difference
            over the element's sum of |terms|; both builds' times on the
            card alone and the host's enqueue times (chip_smoke.device_ms),
            in the order other, this, this, other;
  flat      the flat step's ms per iteration on chip_smoke.py's nine plans
            with either build's kernels (median of 5 CUDA-event timings of
            20 iterations each; the same order).
"""

from __future__ import annotations

import argparse
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


def build_other(root: str, work: str):
    """nvcc the other checkout's csrc into ``work``; returns the loaded
    library and whether its kernel A takes the hub list."""
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
    hubs = hasattr(lib, "ge_spmv_hub_row")
    if not hubs:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ge_edge_spmm.argtypes = [i, i, p, p, p, p, p, p]
        for fn in (lib.ge_edge_spmm_bf16x, lib.ge_edge_spmm_null):
            fn.argtypes = [i, i, p, p, p, p, p]
    return lib, hubs


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
def use(lib, hubs: bool):
    """Route the port's kernel wrappers to ``lib`` inside the block."""
    from graph_embed_tpu_torch.ops import cuda
    from graph_embed_tpu_torch.ops import edge_spmm as ES

    names = ("spmv_cuda", "spmv_bf16x_cuda", "spmv_null_cuda")
    saved = (cuda._LIB, *(getattr(ES, n) for n in names))
    cuda._LIB = lib
    if not hubs:
        for n, fn in zip(names, _planless(lib)):
            setattr(ES, n, fn)
    try:
        yield
    finally:
        cuda._LIB = saved[0]
        for n, fn in zip(names, saved[1:]):
            setattr(ES, n, fn)


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


def compare(kernel: str, shape: str, fn, scale, this, other,
            **fields) -> None:
    """One kernel on one shape with both builds: equality, the largest
    difference over scale, both times."""
    import torch

    outs = {}
    for label, lib in (("this", this), ("other", other)):
        with use(*lib):
            outs[label] = fn()
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
    cases.append(("exact", "community tiered nohubs",
                  lj["community tiered nohubs"][1].csr))
    cases.append(("vnull", "community bf16", lj["community bf16"][1].csr))
    cases.append(("vnull", "rmat(20,8)", flat["rmat(20,8)"][1].csr))
    out = []
    for mode, shape, csr in cases:
        x = torch.rand((csr.n_cols, 3), generator=gen, device=dev) * 2 - 1
        out.append((mode, shape, csr, x))
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True,
                    help="root of the other checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_ab: needs a CUDA device", file=sys.stderr)
        return 1
    import graph_embed_tpu_torch as gp
    from graph_embed_tpu_torch.graph import synth
    from graph_embed_tpu_torch.ops import cuda
    from graph_embed_tpu_torch.ops import edge_spmm as ES
    from graph_embed_tpu_torch.ops import fused_step as FS
    from graph_embed_tpu_torch.ops import repulsion as RP

    dev = torch.device("cuda", 0)
    CS.phase_env(torch)
    work = tempfile.mkdtemp(prefix="kernel_ab_")
    try:
        this = (cuda.library(), True)
        other = build_other(os.path.abspath(args.other), work)
        CS.emit(phase="build", other=args.other, other_takes_hubs=other[1])

        g = synth.mesh3d(CS.MESH_SIDE)
        res = gp.partition_hierarchy(g, 0.1, emit_graphs=True)
        flat = CS.setup_flat(dev, g)
        lj = CS.setup_lj(dev)

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
                        CS.drive_steps(torch, tfa, params, dev,
                                       CS.FLAT_ITERS, seed=rep)
                        b.record()
                        b.synchronize()
                        per.append(a.elapsed_time(b) / CS.FLAT_ITERS)
                    times[label].append(statistics.median(per))
            CS.emit(phase="flat", plan=name, n=graph.n,
                    stored_entries=graph.num_edges,
                    this_ms_per_iteration=statistics.fmean(times["this"]),
                    other_ms_per_iteration=statistics.fmean(times["other"]),
                    runs=times)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
