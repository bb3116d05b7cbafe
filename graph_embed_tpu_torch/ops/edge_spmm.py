"""Attraction over a row-sorted CSR: kernel A (the SpMV, four modes) and
kernel E (linlog attraction), both in ``csrc/edge_spmm.cu``.

Counterpart of graph_embed_tpu/ops/pallas/edge_spmm.py.  The TPU packs
edges into (sender block, receiver window) slabs of one-hot matmuls over a
transposed [8, n_pad] coordinate state; here ``y = A x`` is a CSR walk over
row-major [n, d] coordinates.  What stays from the reference is the host
prep that fixes the arithmetic, carried by the CSR's ``kind``:

* ``unit``: every weight is 1 (kernel A's unit mode; the reference's
  'unit' packing, ``_spmv_kernel_v12pk`` and its older tilings);
* ``weighted``: weights as the reference applies them on its bf16 paths,
  truncated toward zero to bf16 (the packer's ``wbits & -65536``,
  edge_spmm.py:581), with the exact float32 weights of overflow edges and
  the nearest-rounded weights of BSR blocks where those apply
  (forceatlas/tiled.py); ``_spmv_kernel_v8``;
* ``exact``: exact float32 weights, the 'wide' packing of a jumbo tier
  (``_spmv_kernel_vw``); kernel A's weighted mode, counted on its own.

Row sums are taken from the same weights (tiled_row_sums, :1581-1600).
Under ``x_precision='bf16'`` a unit CSR whose tiling the reference would
pair (``bf16_gather``) gathers x rounded to nearest bf16, two coordinates
per 32-bit word (``pack_x_bf16``; kernel A's bf16x mode, the reference's
``_spmv_kernel_v12pk(bf16_x=True)``).  ``spmv_windowed`` takes the
reference's variant names and routes each onto one of these modes; the
stream-only ``vnull`` mode is its diagnostic floor.

Kernel A walks tiles of consecutive rows, a thread or a warp per row, and
gives each hub row (more than ``cuda.SPMV_HUB_ROW`` entries) a block of
its own; the hub list is the CSR's one piece of plan (``plan_hub_rows``),
built with it.

Kernel E is the linlog attraction of edge_spmm.py:attraction_tiled
(:240, body ``_attraction_kernel`` :203): per stored entry the distance,
``attract * c_e * log1p(d)/d * (x_col - x_row)``, summed per row with the
folded float32 weights as ``build_edge_tiles`` keeps them (not truncated),
on kernel A's walk and the same hub list.

Every entry point launches its kernel on a CUDA tensor and runs the plain
PyTorch version on a CPU tensor; there is no fallback between the two.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import cuda

D_PAD = 8  # the reference's coordinate sublane pad (v11's 2*dmax limit)
X_PRECISIONS = ("f32", "bf16")
#: the reference's explicit variant names (edge_spmm.py:1423-1476)
UNIT_VARIANTS = ("v6", "v7", "v9", "v10", "v11", "v9p2", "v9p4", "v9p8",
                 "v12", "v12p2", "v12p4", "v12p8", "v12p16",
                 "v12b", "v12bp2", "v12bp4", "v12bp8", "v12bp16", "vnull")
WEIGHTED_VARIANTS = ("v4", "v6", "v7", "v8")
#: slabs per pallas_call above which the reference chunks its tiling and
#: stops pairing it (edge_spmm.py:431)
MAX_SLABS_PER_CALL = 65536
#: window lanes from which the reference pairs unit tiles (:333)
JUMBO_JOIN_MIN = 2048


@dataclasses.dataclass(frozen=True)
class EdgeCSR:
    """Row-sorted CSR of an [n_rows, n_cols] matrix on one device.

    indptr: [n_rows+1] int32; col: [nnz] int32; w: [nnz] float32, or None
    when every stored weight is exactly 1 (kernel A's unit mode).
    ``exact``: the weights are the reference's exact float32 weight plane
    (its 'wide' packing) rather than its truncated bf16 words.
    ``bf16_gather``: the reference's dispatch would take the bf16-pair
    gather for this unit CSR under ``x_precision='bf16'``.
    ``hub_rows``: kernel A's plan, built with the CSR from ``indptr`` on
    its device when not given (``plan_hub_rows``)."""

    indptr: torch.Tensor
    col: torch.Tensor
    w: torch.Tensor | None
    n_rows: int
    n_cols: int
    exact: bool = False
    bf16_gather: bool = False
    hub_rows: torch.Tensor | None = None

    def __post_init__(self):
        if self.hub_rows is None:
            object.__setattr__(self, "hub_rows",
                               plan_hub_rows(self.indptr))

    @property
    def nnz(self) -> int:
        return int(self.col.shape[0])

    @property
    def device(self) -> torch.device:
        return self.col.device

    @property
    def kind(self) -> str:
        """'unit', 'weighted' (the reference's bf16 words) or 'exact'."""
        if self.w is None:
            return "unit"
        return "exact" if self.exact else "weighted"


def plan_hub_rows(indptr: torch.Tensor) -> torch.Tensor:
    """Kernel A's plan of a CSR: the ids, ascending, of its rows of more
    than ``cuda.SPMV_HUB_ROW`` entries, as [n_hubs] int32 on ``indptr``'s
    device.  Each such row gets a block of its own; every other row is
    summed in its tile of consecutive rows.  A row's class depends on its
    length alone, never on where it starts.  Built once with the CSR, from
    the host (``build_csr``) or the device (``segment.sorted_csr``) row
    pointers alike; on the device it waits once for the count."""
    lens = indptr[1:] - indptr[:-1]
    hubs = torch.nonzero(lens > cuda.SPMV_HUB_ROW).flatten()
    return hubs.to(torch.int32)


def truncate_bf16(w) -> np.ndarray:
    """float32 weights truncated toward zero to bf16 precision (the low 16
    bits cleared), exactly as the reference packer stores them.  Rounding
    to nearest (``tensor.to(torch.bfloat16)``) would disagree with it."""
    wb = np.ascontiguousarray(np.asarray(w, dtype=np.float32))
    return (wb.view(np.int32) & np.int32(-65536)).view(np.float32)


def build_csr(rows, cols, w, n_rows: int, n_cols: int | None = None, *,
              device="cpu", exact: bool = False,
              bf16_gather: bool = False) -> tuple[EdgeCSR, torch.Tensor]:
    """Host CSR build from a COO; returns (csr, row sums).

    ``w=None`` builds the unit-weight CSR.  Entries keep their input order
    within a row (a stable sort by row), which fixes the kernel's summation
    order.  The row sums are float64 sums of the float32 weights cast to
    float32, as ``tiled_row_sums`` computes them."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    n_cols = n_rows if n_cols is None else n_cols
    if rows.size >= 1 << 31 or max(n_rows, n_cols) >= 1 << 31:
        raise ValueError("kernel A indexes with int32")
    if rows.size and np.any(rows[1:] < rows[:-1]):
        order = np.argsort(rows, kind="stable")
        rows, cols = rows[order], cols[order]
        if w is not None:
            w = np.asarray(w)[order]
    counts = np.bincount(rows, minlength=n_rows)
    indptr = np.zeros(n_rows + 1, dtype=np.int32)
    indptr[1:] = np.cumsum(counts)
    if w is None:
        wt = None
        deg = counts.astype(np.float32)
    else:
        w32 = np.ascontiguousarray(np.asarray(w, dtype=np.float32))
        wt = torch.from_numpy(w32).to(device)
        deg = np.bincount(rows, weights=w32.astype(np.float64),
                          minlength=n_rows).astype(np.float32)
    host_indptr = torch.from_numpy(indptr)
    csr = EdgeCSR(indptr=host_indptr.to(device),
                  col=torch.from_numpy(cols.astype(np.int32)).to(device),
                  w=wt, n_rows=int(n_rows), n_cols=int(n_cols),
                  exact=bool(exact and w is not None),
                  bf16_gather=bool(bf16_gather and w is None),
                  hub_rows=plan_hub_rows(host_indptr).to(device))
    return csr, torch.from_numpy(deg).to(device)


def _rows(csr: EdgeCSR) -> torch.Tensor:
    """[nnz] row id of every stored entry."""
    counts = (csr.indptr[1:] - csr.indptr[:-1]).long()
    return torch.repeat_interleave(
        torch.arange(csr.n_rows, device=csr.device), counts)


def spmv_plain(x: torch.Tensor, csr: EdgeCSR) -> torch.Tensor:
    """Plain PyTorch version of kernel A: y[i] = sum_e w_e x[col_e]."""
    rows = _rows(csr)
    vals = x[csr.col.long()]
    if csr.w is not None:
        vals = vals * csr.w[:, None]
    y = torch.zeros((csr.n_rows, x.shape[1]), dtype=x.dtype, device=x.device)
    return y.index_add_(0, rows, vals)


def _plan(csr: EdgeCSR, floats: int) -> tuple:
    """The walk's plan arguments, (hub rows, their count, the hub blocks'
    staging buffer), and that buffer, to be held until the launch: CHUNK =
    ``cuda.SPMV_HUB_ROW`` entries of ``floats`` floats per hub block, per
    call (kernel A stages d, kernel E d + 1)."""
    n = int(csr.hub_rows.shape[0])
    if not n:
        return (None, 0, None), None
    if csr.hub_rows.device != csr.device:
        raise ValueError("the CSR's hub rows lie on another device")
    stage = torch.empty(n * cuda.SPMV_HUB_ROW * floats, dtype=torch.float32,
                        device=csr.device)
    return (csr.hub_rows.data_ptr(), n, stage.data_ptr()), stage


def spmv_cuda(x: torch.Tensor, csr: EdgeCSR) -> torch.Tensor:
    """Kernel A on the card: y = A x for float32 [n_cols, d <= 4] x (unit
    mode without weights, weighted mode with them; an exact CSR counts as
    the 'wide' route)."""
    _check_coords(x, csr, "kernel A")
    y = torch.empty((csr.n_rows, x.shape[1]), dtype=torch.float32,
                    device=x.device)
    if csr.n_rows == 0:
        return y
    plan, _stage = _plan(csr, x.shape[1])
    with torch.cuda.device(x.device):
        rc = cuda.library().ge_edge_spmm(
            csr.n_rows, x.shape[1], csr.indptr.data_ptr(),
            csr.col.data_ptr(), None if csr.w is None else csr.w.data_ptr(),
            x.data_ptr(), y.data_ptr(), *plan, cuda.stream_of(x))
    cuda.check(rc, "edge_spmm")
    cuda.LAUNCHES[f"edge_spmm[{csr.kind}]"] += 1
    return y


def spmv(x: torch.Tensor, csr: EdgeCSR) -> torch.Tensor:
    """y = A x: kernel A for a CUDA tensor, the plain version for a CPU
    tensor."""
    if x.is_cuda:
        return spmv_cuda(x, csr)
    if x.device.type != "cpu":
        raise ValueError(f"spmv runs on CUDA or the CPU, not {x.device}")
    return spmv_plain(x, csr)


def pack_x_bf16(x: torch.Tensor) -> torch.Tensor:
    """[n, d] float32 -> [n, ceil(d/2)] int32 words of bf16 pairs, the
    counterpart of pack_gather_layout_bf16 (edge_spmm.py:1167): coordinate
    2p rounded to nearest-even bf16 in the high half, 2p+1 in the low half
    (0 past d).  Plain torch ops, as the reference computes it outside its
    kernel; the words are little-endian pairs of bf16 halves."""
    n, d = x.shape
    d2 = (d + 1) // 2
    xb = torch.zeros((n, d2, 2), dtype=torch.bfloat16, device=x.device)
    xb[:, :, 1] = x[:, 0::2]
    xb[:, : d // 2, 0] = x[:, 1::2]
    return xb.view(torch.int32).reshape(n, d2)


def unpack_x_bf16(xp: torch.Tensor, d: int) -> torch.Tensor:
    """[n, ceil(d/2)] bf16-pair words -> [n, d] float32: the high half of
    word p is coordinate 2p, the low half 2p+1 (each exact in float32)."""
    halves = xp.contiguous().view(torch.bfloat16).float()   # lo, hi, ...
    x = torch.empty_like(halves)
    x[:, 0::2] = halves[:, 1::2]
    x[:, 1::2] = halves[:, 0::2]
    return x[:, :d].contiguous()


def spmv_bf16x_plain(xp: torch.Tensor, csr: EdgeCSR, d: int) -> torch.Tensor:
    """Plain version of kernel A's bf16x mode: y = A unpack(xp)."""
    return spmv_plain(unpack_x_bf16(xp, d), csr)


def _check_unit(csr: EdgeCSR, name: str) -> None:
    if csr.w is not None:
        raise ValueError(f"{name} takes a unit-weight CSR")


def spmv_bf16x_cuda(xp: torch.Tensor, csr: EdgeCSR, d: int) -> torch.Tensor:
    """Kernel A's bf16x mode on the card: y = A x for x given as
    ``pack_x_bf16`` words, unit weights, float32 sums."""
    _check_unit(csr, "kernel A's bf16x mode")
    if not xp.is_cuda or csr.device != xp.device:
        raise ValueError("kernel A's bf16x mode needs the packed x and the "
                         "CSR on one CUDA device")
    if not 1 <= d <= 4 or xp.dtype != torch.int32 or not xp.is_contiguous() \
            or tuple(xp.shape) != (csr.n_cols, (d + 1) // 2) \
            or xp.data_ptr() % 8:
        raise ValueError(f"kernel A's bf16x mode takes contiguous, 8-byte "
                         f"aligned int32 [{csr.n_cols}, {(d + 1) // 2}] "
                         f"words for d={d} "
                         f"<= 4, got {xp.dtype} {tuple(xp.shape)}")
    y = torch.empty((csr.n_rows, d), dtype=torch.float32, device=xp.device)
    if csr.n_rows == 0:
        return y
    plan, _stage = _plan(csr, d)
    with torch.cuda.device(xp.device):
        rc = cuda.library().ge_edge_spmm_bf16x(
            csr.n_rows, d, csr.indptr.data_ptr(), csr.col.data_ptr(),
            xp.data_ptr(), y.data_ptr(), *plan, cuda.stream_of(xp))
    cuda.check(rc, "edge_spmm_bf16x")
    cuda.LAUNCHES["edge_spmm[bf16x]"] += 1
    return y


def spmv_bf16x(xp: torch.Tensor, csr: EdgeCSR, d: int) -> torch.Tensor:
    """y = A x over bf16-pair words: kernel A's bf16x mode for a CUDA
    tensor, the plain version for a CPU tensor."""
    _check_unit(csr, "kernel A's bf16x mode")
    if xp.is_cuda:
        return spmv_bf16x_cuda(xp, csr, d)
    if xp.device.type != "cpu":
        raise ValueError(f"spmv runs on CUDA or the CPU, not {xp.device}")
    return spmv_bf16x_plain(xp, csr, d)


def spmv_null_cuda(x: torch.Tensor, csr: EdgeCSR) -> torch.Tensor:
    """Kernel A's stream-only mode (the reference's diagnostic
    ``_spmv_kernel_vnull``, :992): the unit mode's launch and loads with
    the sum discarded; writes zeros.  Its time is kernel A's memory-stream
    floor on the card."""
    _check_unit(csr, "kernel A's stream-only mode")
    _check_coords(x, csr, "kernel A's stream-only mode")
    y = torch.empty((csr.n_rows, x.shape[1]), dtype=torch.float32,
                    device=x.device)
    if csr.n_rows == 0:
        return y
    plan, _stage = _plan(csr, x.shape[1])
    with torch.cuda.device(x.device):
        rc = cuda.library().ge_edge_spmm_null(
            csr.n_rows, x.shape[1], csr.indptr.data_ptr(),
            csr.col.data_ptr(), x.data_ptr(), y.data_ptr(), *plan,
            cuda.stream_of(x))
    cuda.check(rc, "edge_spmm_null")
    cuda.LAUNCHES["edge_spmm[vnull]"] += 1
    return y


def spmv_null_plain(x: torch.Tensor, csr: EdgeCSR) -> torch.Tensor:
    """Plain version of the stream-only mode: zeros of the output shape."""
    return torch.zeros((csr.n_rows, x.shape[1]), dtype=x.dtype,
                       device=x.device)


def spmv_null(x: torch.Tensor, csr: EdgeCSR) -> torch.Tensor:
    """The stream-only mode for a CUDA tensor, its plain version for a CPU
    tensor."""
    _check_unit(csr, "kernel A's stream-only mode")
    if x.is_cuda:
        return spmv_null_cuda(x, csr)
    if x.device.type != "cpu":
        raise ValueError(f"spmv runs on CUDA or the CPU, not {x.device}")
    return spmv_null_plain(x, csr)


def spmv_windowed(x: torch.Tensor, csr: EdgeCSR, *, variant: str = "auto",
                  x_precision: str = "f32", dmax: int = 4) -> torch.Tensor:
    """y = A x under the reference's dispatch (edge_spmm.py:1387-1476).

    Every variant name the reference accepts for the CSR's kind routes onto
    kernel A: ``v12b*`` (and 'auto' under ``x_precision='bf16'`` on a
    ``bf16_gather`` CSR) to the bf16x mode, ``vnull`` to the stream-only
    mode, the rest to the unit or weighted mode.  An exact CSR takes the
    'wide' route whatever the name, as in the reference.  Unknown names
    and precisions raise ValueError with the reference's messages."""
    if x_precision not in X_PRECISIONS:
        raise ValueError(f"unknown x_precision {x_precision!r} "
                         "('f32' or 'bf16')")
    kind = csr.kind
    if kind == "exact":
        return spmv(x, csr)
    if kind == "weighted":
        if variant != "auto" and variant not in WEIGHTED_VARIANTS:
            raise ValueError(f"unknown spmv_windowed variant {variant!r} "
                             "for bf16 packing")
        return spmv(x, csr)
    if variant == "auto":
        variant = ("v12b" if x_precision == "bf16" and csr.bf16_gather
                   else "v12")
    if variant not in UNIT_VARIANTS:
        raise ValueError(f"unknown spmv_windowed variant {variant!r} "
                         "for unit packing")
    if variant == "v11" and 2 * dmax > D_PAD:
        raise ValueError(
            f"variant='v11' splits coords into hi/lo rows and needs "
            f"2*dmax <= D_PAD (got dmax={dmax}, D_PAD={D_PAD})")
    if variant.startswith("v12b"):
        return spmv_bf16x(pack_x_bf16(x), csr, x.shape[1])
    if variant == "vnull":
        return spmv_null(x, csr)
    return spmv(x, csr)


def spmv_windowed_v5(x: torch.Tensor, csr: EdgeCSR) -> torch.Tensor:
    """The reference's manually pipelined entry (spmv_windowed_v5, :1692):
    the same y = A x on truncated bf16 weights, kernel A's weighted mode."""
    if csr.kind != "weighted":
        raise ValueError("v5 decodes the bf16 word layout only")
    return spmv(x, csr)


def attraction_spmv(x: torch.Tensor, csr: EdgeCSR, deg_w: torch.Tensor, *,
                    attract: float = 1.0,
                    x_precision: str = "f32") -> torch.Tensor:
    """Plain-FA attraction through the SpMV (edge_spmm.py:1603-1611):
    F_att = attract * (A x - x * deg_w); only the gathered x of A x is
    quantized under ``x_precision='bf16'``."""
    y = spmv_windowed(x, csr, x_precision=x_precision)
    return attract * (y - x * deg_w[:, None])


def _pow2(v: int, name: str) -> int:
    if v < 128 or v & (v - 1) or v % 128:
        raise ValueError(f"{name} must be a power of two >= 128, got {v}")
    return v.bit_length() - 1


def build_tiered_csr(s, r, w, n: int, *, specs, thresholds,
                     packing: str = "bf16",
                     device="cpu") -> tuple[EdgeCSR, torch.Tensor]:
    """One CSR from the reference's tiered tiling (build_tiered_tiles,
    edge_spmm.py:670-699); returns (csr, row sums), the row sums the
    counterpart of tiered_row_sums (:717).

    ``specs`` = [(sender_block, window, tile), ...] coarse to jumbo;
    ``thresholds`` = per-tier edges a (block, window) cell must hold for
    that tier to claim it (one fewer than the specs; the last tier claims
    every remaining edge).  Cells are claimed exactly as the reference
    claims them; each tier then stores its weights by its packing: unit,
    truncated bf16 where log2 B + log2 W <= 16, exact float32 ('wide')
    above.  The CSR is exact when every tier is wide.  Zero weights are
    dropped, as the packer drops them.  One merged CSR needs no per-tier
    sum (spmv_tiered, :702): ``spmv_windowed`` runs it, and its
    ``bf16_gather`` stays False, as the reference passes its tiers no
    ``x_precision``."""
    if len(thresholds) != len(specs) - 1:
        raise ValueError("one threshold per tier but the last")
    if packing not in ("unit", "bf16"):
        raise ValueError(f"unknown packing {packing!r}")
    s = np.asarray(s, dtype=np.int64)
    r = np.asarray(r, dtype=np.int64)
    w = np.asarray(w, dtype=np.float64)
    if packing == "unit" and not np.all(w == 1.0):
        raise ValueError("unit packing requires unit weights")
    live = w != 0.0
    remaining = live.copy()
    wt = np.zeros(s.size, np.float32)
    all_wide = True
    for i, (B, W, _tile) in enumerate(specs):
        bits = _pow2(B, "sender_block") + _pow2(W, "window")
        if i < len(specs) - 1:
            nwin = max(-(-n // W), 1)
            cell = (s[remaining] // B) * nwin + r[remaining] // W
            _, inv, counts = np.unique(cell, return_inverse=True,
                                       return_counts=True)
            claim = np.zeros(s.size, bool)
            claim[remaining] = counts[inv.ravel()] >= thresholds[i]
        else:
            claim = remaining
        wide = packing == "bf16" and bits > 16
        all_wide &= wide
        if wide:
            wt[claim] = w[claim].astype(np.float32)
        elif packing == "bf16":
            wt[claim] = truncate_bf16(w[claim])
        remaining = remaining & ~claim
    return build_csr(s[live], r[live], None if packing == "unit"
                     else wt[live], n, device=device,
                     exact=all_wide and packing == "bf16")


def slab_count(s, r, n: int, sender_block: int, window: int,
               tile: int) -> int:
    """The slab count of the reference's build_window_tiles (:551-562) on
    the given (nonzero-weight) edges: ceil(count / tile) for each live
    (sender block, receiver window) cell, plus one dummy slab for each
    edgeless sender block up to the lcm-padded block count."""
    s = np.asarray(s, dtype=np.int64)
    r = np.asarray(r, dtype=np.int64)
    n_sblocks = max(-(-n // sender_block), 1)
    nwin = max(-(-(n_sblocks * sender_block) // window), 1)
    cells, counts = np.unique((s // sender_block) * nwin + r // window,
                              return_counts=True)
    unit = math.lcm(sender_block, window)
    n_out_blocks = (-(-(n_sblocks * sender_block) // unit) * unit
                    ) // sender_block
    seen = np.unique(cells // nwin).size
    return int((-(-counts // tile)).sum()) + n_out_blocks - seen


def _check_coords(x: torch.Tensor, csr: EdgeCSR, name: str) -> None:
    if not x.is_cuda or csr.device != x.device:
        raise ValueError(f"{name} needs x and the CSR on one CUDA device")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"{name} takes contiguous float32 coordinates")
    if x.dim() != 2 or x.shape[0] != csr.n_cols or not 1 <= x.shape[1] <= 4:
        raise ValueError(f"{name} takes [{csr.n_cols}, d<=4] coordinates, "
                         f"got {tuple(x.shape)}")


def linlog_plain(x: torch.Tensor, csr: EdgeCSR, *, attract: float,
                 eps: float, absolute: bool = False) -> torch.Tensor:
    """Plain PyTorch version of kernel E: F[i] = sum_e attract * c_e *
    log1p(d_e)/d_e * (x[col_e] - x[i]), d_e = max(|x[col_e] - x[i]|, eps),
    for the rows i < n_rows of x.
    ``absolute`` sums the terms' magnitudes instead: the scale of each
    element's float32 rounding, against which kernel E is held."""
    if csr.w is None:
        raise ValueError("linlog attraction needs the folded weights")
    rows = _rows(csr)
    diff = x[csr.col.long()] - x[rows]
    dist = torch.clamp(torch.sqrt(torch.sum(diff * diff, dim=1)), min=eps)
    per_edge = diff * (attract * csr.w * torch.log1p(dist) / dist)[:, None]
    if absolute:
        per_edge = per_edge.abs()
    out = torch.zeros((csr.n_rows, x.shape[1]), dtype=x.dtype,
                      device=x.device)
    return out.index_add_(0, rows, per_edge)


def linlog_cuda(x: torch.Tensor, csr: EdgeCSR, *, attract: float,
                eps: float) -> torch.Tensor:
    """Kernel E on the card: linlog attraction for float32 [n_cols, d <= 4]
    coordinates over a CSR with float32 weights whose rows are the first
    n_rows of them (square, or the halo step's [x | pool] columns).  It
    walks the CSR as kernel A does, a block for each of its hub rows."""
    _check_coords(x, csr, "kernel E")
    if csr.w is None or csr.n_rows > csr.n_cols:
        raise ValueError("kernel E takes a CSR with weights and no more "
                         "rows than columns")
    out = torch.empty((csr.n_rows, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    if csr.n_rows == 0:
        return out
    plan, _stage = _plan(csr, x.shape[1] + 1)
    with torch.cuda.device(x.device):
        rc = cuda.library().ge_edge_linlog(
            csr.n_rows, x.shape[1], csr.indptr.data_ptr(), csr.col.data_ptr(),
            csr.w.data_ptr(), x.data_ptr(), out.data_ptr(), float(attract),
            float(eps), *plan, cuda.stream_of(x))
    cuda.check(rc, "edge_linlog")
    cuda.LAUNCHES["edge_linlog"] += 1
    return out


def linlog(x: torch.Tensor, csr: EdgeCSR, *, attract: float,
           eps: float) -> torch.Tensor:
    """Linlog attraction: kernel E for a CUDA tensor, the plain version for
    a CPU tensor."""
    if x.is_cuda:
        return linlog_cuda(x, csr, attract=attract, eps=eps)
    if x.device.type != "cpu":
        raise ValueError(f"linlog runs on CUDA or the CPU, not {x.device}")
    return linlog_plain(x, csr, attract=attract, eps=eps)
