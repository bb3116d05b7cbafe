"""The ring halo exchange overlapped with the cross-edge attraction:
kernel F (``csrc/ring_attraction.cu``) and its ring transport.

Counterpart of graph_embed_tpu/parallel/overlap.py.  The collective halo
step gathers every boundary block first and only then computes the
cross-edge attraction.  The ring variant passes the boundary blocks around
the shards instead and computes the attraction of the cross edges that
receive from a block while the next block is in flight.

* Host planning (``build_overlap_groups``, overlap.py:74-152): the cross
  edges of each shard grouped by ring *arrival* slot -- slot k of shard s
  holds the edges whose receiver is exported by shard (s - k) % ndev --
  padded to ``ec_max``, plus the local edge split with the cross edges
  deadened (sender -> ghost row ``blk``).  The TPU kernel's B_max % 128
  check (:106) served its lane gather and is dropped; ``halo_force_atlas``
  still rounds B_max to 128 for ``overlap=True``, so both packages build
  the same plan.
* The ring transport on one device (``ring_cross_forces``): a slot buffer
  ``[slot, shard, B_max, d]``.  Slot 0 gathers each shard's own boundary
  rows; then slot k is forwarded to the right neighbour's slot k + 1 (one
  ``copy_`` of the shard-rolled slice, on a side CUDA stream) while kernel
  F runs slot k on the compute stream.  Events order the two streams: F(k)
  waits for the copy that wrote slot k, and the copy out of slot k waits
  for slot k's data.  Slots are written once, and each holds exactly the
  block that lands at that ring step, as on the TPU.  On a mesh that
  spans processes a process's buffer holds its own shards, and the one
  hop that leaves it (its last shard's block to the next process's first)
  is a send/recv pair (``multihost.Comm.shift``); the hops inside it stay
  copies.  The buffer is slot-major
  (not the reference's per-device [D_PAD, B_max] slots) so that each ring
  step reads and writes one contiguous block.  On the CPU the same code
  runs the copies in order.
* Kernel F computes one slot for every shard at once: per cross edge the
  attraction of forces.attraction_fa (``slot_forces_cuda``); its plain
  version ``slot_forces_plain``.  Each group's live entries are a prefix
  with mask 1 (``RingGroups.live`` counts them): the kernel reads nothing
  past it and no mask.  The per-edge forces ``[slot, shard, ec_max, d]``
  are summed per sender outside, over every slot in slot order, by the
  row-owned segment sum (``RingGroups.csr``).  A ring checks its operands
  once and launches its slots unchecked (``ring_slot_forces``,
  ``ring_cross_forces``).

``ring_cross_forces`` launches kernel F for a CUDA tensor and raises for
what it does not take; ``ring_cross_forces_plain`` runs only where the
caller asks for it (every CPU tensor goes there).  No fallback between
the two.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..forceatlas import forces as F
from ..ops import cuda
from ..ops import edge_spmm as ES
from ..utils.params import ForceAtlasParams
from .mesh import round_up

LANE = 128   # Ec_max rounds to this, as the reference's lane tiling does


@dataclasses.dataclass(frozen=True)
class OverlapGroups:
    """Cross-edge groups in ring-arrival order and the local-only split
    (host numpy, stacked per shard on axis 0, as the reference's).

    ``cs/cr/cw/mask[shard, slot, ec_max]``: slot k holds the cross edges of
    ``shard`` receiving from the boundary block of (shard - k) % ndev (slot
    0, the shard's own block, is empty by construction).  ``cr`` indexes
    the source shard's export list (< B_max).  ``local_*`` mirror
    HaloPlan.senders_loc/recv_idx/weights with the cross edges deadened."""

    ndev: int
    ec_max: int
    cs: np.ndarray            # [ndev, ndev, Ec_max] int32, pad = blk (ghost)
    cr: np.ndarray            # [ndev, ndev, Ec_max] int32, pad = 0
    cw: np.ndarray            # [ndev, ndev, Ec_max] weight, pad = 0
    mask: np.ndarray          # [ndev, ndev, Ec_max] 1.0 live / 0.0 pad
    local_senders: np.ndarray  # [ndev, e_max] int32
    local_recv: np.ndarray     # [ndev, e_max] int32
    local_weights: np.ndarray  # [ndev, e_max]


def build_overlap_groups(plan) -> OverlapGroups:
    """Ring-ordered cross-edge groups of a HaloPlan (overlap.py:99-152)."""
    ndev, blk, B_max = plan.ndev, plan.blk, plan.B_max

    per = [[[] for _ in range(ndev)] for _ in range(ndev)]
    for d in range(ndev):
        s_loc = plan.senders_loc[d]
        r_idx = plan.recv_idx[d]
        w = plan.weights[d]
        cross = (r_idx >= blk) & (s_loc < blk)
        pool = r_idx[cross] - blk
        src = pool // B_max
        slot = (d - src) % ndev
        within = pool % B_max
        cs_d = s_loc[cross]
        cw_d = w[cross]
        for k in range(ndev):
            sel = slot == k
            per[d][k] = (cs_d[sel], within[sel], cw_d[sel])

    ec_max = max((g[0].size for row in per for g in row), default=0)
    ec_max = max(round_up(max(ec_max, 1), LANE), LANE)
    cs = np.full((ndev, ndev, ec_max), blk, np.int32)
    cr = np.zeros((ndev, ndev, ec_max), np.int32)
    cw = np.zeros((ndev, ndev, ec_max), plan.weights.dtype)
    mask = np.zeros((ndev, ndev, ec_max), np.float32)
    for d in range(ndev):
        for k in range(ndev):
            a, b, c = per[d][k]
            m = a.size
            cs[d, k, :m] = a
            cr[d, k, :m] = b
            cw[d, k, :m] = c
            mask[d, k, :m] = 1.0

    local_senders = plan.senders_loc.copy()
    local_recv = plan.recv_idx.copy()
    local_weights = plan.weights.copy()
    is_cross = local_recv >= blk
    local_senders[is_cross] = blk            # ghost row: dropped
    local_recv[is_cross] = 0
    local_weights[is_cross] = 0
    return OverlapGroups(ndev=ndev, ec_max=ec_max, cs=cs, cr=cr, cw=cw,
                         mask=mask, local_senders=local_senders,
                         local_recv=local_recv, local_weights=local_weights)


@dataclasses.dataclass(frozen=True)
class RingGroups:
    """The groups on the device, slot-major, and what the ring needs: the
    ring has ``ndev`` slots, and this process holds ``shards`` of its
    shards (all of them in one process), whose groups these are.

    cs/cr: [slot, shard, ec] int32; cw/mask: [slot, shard, ec] float32
    (kernel F reads no mask; the plain version does); live: [slot, shard]
    int32, the live entries of each group, a prefix of it with mask 1 (the
    rest is padding, mask 0); bidx: [shards * B_max] int64 rows of this
    process's coordinates that its shards export (slot 0 of the ring); csr: the live entries of the per-edge output ``[slot,
    shard, ec, d]`` (flattened, slot-major) by this process's sender row,
    the order in which the cross forces are summed; side: the CUDA stream
    of the ring's forwards (None on the CPU); comm: the mesh's
    ``multihost.Comm`` where the ring spans processes."""

    cs: torch.Tensor
    cr: torch.Tensor
    cw: torch.Tensor
    mask: torch.Tensor
    live: torch.Tensor
    bidx: torch.Tensor
    csr: ES.EdgeCSR
    ndev: int
    blk: int
    b_max: int
    ec: int
    shards: int
    side: torch.cuda.Stream | None = None
    comm: object = None

    @property
    def live_edges(self) -> int:
        return self.csr.nnz


def ring_groups(groups: OverlapGroups, plan, device, *,
                shards: range | None = None, comm=None) -> RingGroups:
    """Put the groups of ``shards`` (every shard by default; one
    process's with the mesh's ``comm``) on ``device`` slot-major, with
    their export rows and summation CSR."""
    ndev, blk = plan.ndev, plan.blk
    shards = range(ndev) if shards is None else shards
    sel = slice(shards.start, shards.stop)

    def slot_major(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(
            np.swapaxes(a[sel], 0, 1)).astype(dtype)).to(device)

    mask = np.swapaxes(groups.mask[sel], 0, 1)       # [slot, shard, ec]
    cs = np.swapaxes(groups.cs[sel], 0, 1)
    counts = np.ascontiguousarray(np.count_nonzero(mask, axis=-1),
                                  dtype=np.int32)
    # kernel F reads neither the padding nor the mask of a live entry
    if not np.array_equal(mask, np.arange(groups.ec_max)
                          < counts[..., None]):
        raise ValueError("every ring group's live entries must be a prefix "
                         "of it, with mask 1")
    live = (mask > 0) & (cs < blk)
    flat = np.flatnonzero(live)
    shard = (flat // groups.ec_max) % len(shards)
    rows = shard.astype(np.int64) * blk + cs.reshape(-1)[flat]
    # a stable sort by row keeps each sender's entries in slot order
    csr, _ = ES.build_csr(rows, flat, None, len(shards) * blk, live.size,
                          device=device)
    return RingGroups(cs=slot_major(groups.cs, np.int32),
                      cr=slot_major(groups.cr, np.int32),
                      cw=slot_major(groups.cw, np.float32),
                      mask=slot_major(groups.mask, np.float32),
                      live=torch.from_numpy(counts).to(device),
                      bidx=torch.from_numpy(plan.export_rows(shards)).to(
                          device),
                      csr=csr,
                      ndev=ndev, blk=blk, b_max=plan.B_max,
                      ec=groups.ec_max, shards=len(shards),
                      side=(torch.cuda.Stream(device)
                            if torch.device(device).type == "cuda"
                            else None),
                      comm=comm)


def slot_forces_plain(block, x, deg_p1, cs, cr, cw, mask, *, blk: int,
                      params: ForceAtlasParams,
                      absolute: bool = False) -> torch.Tensor:
    """Plain PyTorch version of kernel F: the per-edge cross attraction of
    one ring slot, [shard, ec, d].

    block: [shard, B_max, d] the slot's boundary rows; x: [shard * blk, d]
    stacked coordinates; deg_p1: [shard * blk]; cs/cr/cw/mask: [shard, ec].
    Padding edges give 0.  ``absolute`` gives |diff| * |coef| per element
    instead, the scale of its float32 rounding."""
    ndev, ec = cs.shape
    shard = torch.arange(ndev, device=x.device)[:, None]
    csl = cs.long()
    live = (mask != 0) & (csl < blk)
    row = shard * blk + torch.clamp(csl, max=blk - 1)
    diff = block[shard, cr.long()] - x[row]
    dist = torch.clamp(torch.sqrt(torch.sum(diff * diff, dim=-1)),
                       min=params.epsilon)
    fa = F.attraction_fa(dist, cw, deg_p1[row], linlog=params.linlog,
                         delta=params.delta, nohubs=params.nohubs,
                         use_weights=params.use_weights)
    coef = params.attract * fa / dist * mask
    out = diff.abs() * coef.abs()[..., None] if absolute \
        else diff * coef[..., None]
    return torch.where(live[..., None], out, torch.zeros_like(out))


def _launch_slot(ptrs, *, ndev: int, ec: int, d: int, blk: int, b_max: int,
                 fa: tuple, stream: int) -> None:
    """Kernel F on one slot, unchecked: ``ptrs`` are the device addresses
    (live counts, cs, cr, cw, block, x, deg + 1, out); ``fa`` the
    attraction parameters in the entry point's order."""
    rc = cuda.library().ge_ring_attraction(ndev, ec, d, blk, b_max, *ptrs[:7],
                                           *fa, ptrs[7], stream)
    cuda.check(rc, "ring_attraction")
    cuda.LAUNCHES["ring_attraction"] += 1


def _fa_args(params: ForceAtlasParams) -> tuple:
    return (float(params.attract), float(params.epsilon), float(params.delta),
            int(params.linlog), int(params.nohubs), int(params.use_weights))


def _check_operands(block, x, deg_p1, groups, live, out, *, lead: tuple,
                    ndev: int, ec: int, blk: int) -> None:
    """What kernel F takes: ``block`` [*lead, ndev, B_max, d], ``groups``
    (cs, cr: int32; cw: float32) [*lead, ndev, ec], ``live`` int32
    [*lead, ndev] and ``out`` float32 [*lead, ndev, ec, d], all contiguous
    on x's CUDA device."""
    d = x.shape[1] if x.dim() == 2 else 0
    dev = x.device
    if not x.is_cuda or any(t.device != dev for t in (block, deg_p1, live,
                                                       out, *groups)):
        raise ValueError("kernel F needs every operand on one CUDA device")
    if not 1 <= d <= 4 or x.dtype != torch.float32 or not x.is_contiguous() \
            or x.shape[0] % blk:
        raise ValueError(f"kernel F takes contiguous float32 [shards * "
                         f"{blk}, d<=4] coordinates, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if block.dim() != len(lead) + 3 \
            or tuple(block.shape[:-2]) != (*lead, ndev) \
            or block.shape[-1] != d or block.dtype != torch.float32 \
            or not block.is_contiguous():
        raise ValueError(f"kernel F takes a contiguous float32 [{ndev}, "
                         f"B_max, {d}] slot block, got {tuple(block.shape)}")
    for t, dt in zip(groups, (torch.int32, torch.int32, torch.float32)):
        if t.dtype != dt or tuple(t.shape) != (*lead, ndev, ec) \
                or not t.is_contiguous():
            raise ValueError(f"kernel F's groups are contiguous [{ndev}, "
                             f"{ec}] int32 cs/cr and float32 cw")
    if live.dtype != torch.int32 or tuple(live.shape) != (*lead, ndev) \
            or not live.is_contiguous():
        raise ValueError(f"kernel F takes contiguous int32 [{ndev}] live "
                         f"counts per slot, got {live.dtype} "
                         f"{tuple(live.shape)}")
    if out.dtype != torch.float32 or tuple(out.shape) != (*lead, ndev, ec, d) \
            or not out.is_contiguous():
        raise ValueError(f"kernel F writes a contiguous float32 [{ndev}, "
                         f"{ec}, {d}] output per slot, got {out.dtype} "
                         f"{tuple(out.shape)}")
    if deg_p1.dtype != torch.float32 or tuple(deg_p1.shape) != (x.shape[0],):
        raise ValueError("deg + 1 must be float32 [shards * blk]")
    if x.shape[0] != ndev * blk or ndev * ec >= 1 << 31:
        raise ValueError("kernel F indexes shards * ec with int32")


def slot_forces_cuda(block, x, deg_p1, cs, cr, cw, live, *, blk: int,
                     params: ForceAtlasParams,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel F on the card: one ring slot, every shard; ``live`` [shard]
    int32 counts each group's live entries, a prefix of it with mask 1
    (``RingGroups.live``), and the rest is written as zeros.  Writes
    ``out`` ([shard, ec, d] float32, allocated if None) and returns it."""
    ndev, ec = cs.shape
    if out is None:
        out = torch.empty((ndev, ec, x.shape[-1]), dtype=torch.float32,
                          device=x.device)
    _check_operands(block, x, deg_p1, (cs, cr, cw), live, out, lead=(),
                    ndev=ndev, ec=ec, blk=blk)
    if ndev * ec == 0:
        return out
    with torch.cuda.device(x.device):
        _launch_slot([t.data_ptr() for t in (
            live, cs, cr, cw, block, x, deg_p1, out)],
                     ndev=ndev, ec=ec, d=x.shape[1], blk=blk,
                     b_max=block.shape[1], fa=_fa_args(params),
                     stream=cuda.stream_of(x))
    return out


def _ring_launcher(x, deg_p1, ring: RingGroups, params: ForceAtlasParams,
                   buf: torch.Tensor, out: torch.Tensor):
    """Check kernel F's operands for every slot of ``ring`` once; returns
    ``launch(k)``, which runs slot k of ``buf`` [slot, shard, B_max, d] into
    ``out[k]`` ([slot, shard, ec, d]) unchecked."""
    ndev, ec, d = ring.shards, ring.ec, x.shape[1]
    _check_operands(buf, x, deg_p1, (ring.cs, ring.cr, ring.cw), ring.live,
                    out, lead=(ring.ndev,), ndev=ndev, ec=ec, blk=ring.blk)
    if buf.shape[-2] != ring.b_max:
        raise ValueError(f"kernel F's ring takes a [slot, shard, "
                         f"{ring.b_max}, d] slot buffer, got "
                         f"{tuple(buf.shape)}")
    kw = dict(ndev=ndev, ec=ec, d=d, blk=ring.blk, b_max=ring.b_max,
              fa=_fa_args(params), stream=cuda.stream_of(x))
    fixed = (x.data_ptr(), deg_p1.data_ptr())
    live, cs, cr, cw, b, o = (t.data_ptr() for t in (
        ring.live, ring.cs, ring.cr, ring.cw, buf, out))
    group, slot_in = 4 * ndev * ec, 4 * ndev * ring.b_max * d
    slot_out = group * d

    def launch(k: int) -> None:
        g = k * group
        _launch_slot((live + 4 * ndev * k, cs + g, cr + g, cw + g,
                      b + k * slot_in, *fixed, o + k * slot_out), **kw)

    return launch


def ring_slot_forces(buf, x, deg_p1, ring: RingGroups,
                     params: ForceAtlasParams,
                     out: torch.Tensor | None = None,
                     slots=None) -> torch.Tensor:
    """Kernel F on the slots ``slots`` (default all) of a filled slot
    buffer ``buf`` [slot, shard, B_max, d], the operands checked once;
    writes them into ``out`` [slot, shard, ec, d] (allocated if None) and
    returns it."""
    if out is None:
        out = torch.empty((ring.ndev, ring.shards, ring.ec, x.shape[1]),
                          dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        launch = _ring_launcher(x, deg_p1, ring, params, buf, out)
        for k in range(ring.ndev) if slots is None else slots:
            launch(k)
    return out


def _forward(buf: torch.Tensor, k: int, comm=None) -> None:
    """Slot k of shard s -> slot k + 1 of shard s + 1 (the ring's hop);
    with ``comm`` this process's last shard's block goes to the next
    process, and the previous process's comes in."""
    buf[k + 1, 1:].copy_(buf[k, :-1])
    buf[k + 1, 0].copy_(buf[k, -1] if comm is None else comm.shift(
        buf[k, -1]))


def _ring(x, deg_p1, ring: RingGroups, params, slot_fn, side) -> torch.Tensor:
    """The ring: slot 0 gathers each shard's boundary rows; slot k is
    forwarded while ``slot_fn(buf, out)(k)`` computes it into ``out[k]``.
    ``side`` is the CUDA stream of the forwards, or None to run everything
    in order."""
    ndev, d = ring.ndev, x.shape[1]
    buf = torch.empty((ndev, ring.shards, ring.b_max, d), dtype=x.dtype,
                      device=x.device)
    out = torch.empty((ndev, ring.shards, ring.ec, d), dtype=x.dtype,
                      device=x.device)
    torch.index_select(x, 0, ring.bidx, out=buf[0].view(-1, d))
    compute = slot_fn(x, deg_p1, ring, params, buf, out)

    if side is None:
        for k in range(ndev):
            compute(k)
            if k + 1 < ndev:
                _forward(buf, k, ring.comm)
        return out
    comp = torch.cuda.current_stream(x.device)
    ready = torch.cuda.Event()
    ready.record(comp)                       # slot 0 gathered
    for k in range(ndev):
        if k + 1 < ndev:
            side.wait_event(ready)           # slot k's data is there
            with torch.cuda.stream(side):
                _forward(buf, k, ring.comm)
                ready = torch.cuda.Event()
                ready.record(side)           # slot k + 1 written
        compute(k)                           # overlaps the forward above
        if k + 1 < ndev:
            comp.wait_event(ready)           # F(k + 1) after its copy
    buf.record_stream(side)
    return out


def _plain_slots(x, deg_p1, ring: RingGroups, params, buf, out):
    def compute(k: int) -> None:
        out[k] = slot_forces_plain(buf[k], x, deg_p1, ring.cs[k], ring.cr[k],
                                   ring.cw[k], ring.mask[k], blk=ring.blk,
                                   params=params)

    return compute


def ring_cross_forces_plain(x, deg_p1, ring: RingGroups,
                            params: ForceAtlasParams) -> torch.Tensor:
    """Plain version of the whole ring: the same transport, the copies in
    order, and ``slot_forces_plain`` per slot.  [slot, shard, ec, d]."""
    return _ring(x, deg_p1, ring, params, _plain_slots, None)


def ring_cross_forces(x, deg_p1, ring: RingGroups,
                      params: ForceAtlasParams) -> torch.Tensor:
    """Per-edge cross-boundary attraction over the ring, [slot, shard, ec,
    d] (overlap.py:274): kernel F per slot, with the forwards on a side
    stream, for a CUDA tensor; the plain version for a CPU tensor."""
    if x.is_cuda:
        if ring.side is None or ring.side.device != x.device:
            raise ValueError("the ring's groups live on another device than "
                             "the coordinates")
        with torch.cuda.device(x.device):
            return _ring(x, deg_p1, ring, params, _ring_launcher, ring.side)
    if x.device.type != "cpu":
        raise ValueError(f"ring_cross_forces runs on CUDA or the CPU, not "
                         f"{x.device}")
    return ring_cross_forces_plain(x, deg_p1, ring, params)
