"""Peaks of the card and the operations and bytes of the work it is held
to (plain arithmetic, the yardstick of every ``*_roofline_pct``).

The counts copy ``chip_smoke.py``'s bound columns (``bound``,
``spmv_bound``, ``pair_ops`` and kernel D's row) and add the whole flat
iteration.  Each input byte is counted read once and each output byte
written once, whatever a kernel reads again, so a share of the roofline
can not pass 100 % unless the time leaves out part of the work.
"""

from __future__ import annotations

# NVIDIA's data sheet, H100 SXM at 700 W: HBM bytes per second, float32
# operations per second off the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def bound_s(nbytes: float, ops: float) -> float:
    """The least seconds of the work: the larger of its bytes over the
    HBM peak and its operations over the float32 peak."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def pair_ops(d: int) -> int:
    """Operations of one repulsion pair: d differences, d products and
    d - 1 sums for d^2, clamp, rsqrt or sqrt and divide, the cube and
    weight (5), and d multiply-adds (2 d)."""
    return 4 * d + 4


def spmv(n_rows: int, n_cols: int, nnz: int, d: int,
         weighted: bool = False) -> tuple[int, int]:
    """(bytes, operations) of y = A x once (kernel A): int32 row pointers
    and column ids (and float32 weights), every row of x read once, y
    written once; a multiply-add per entry and coordinate (an add in the
    unit mode)."""
    k = 2 if weighted else 1
    nbytes = 4 * (n_rows + 1) + 4 * nnz * k + 4 * d * n_cols + 4 * d * n_rows
    return nbytes, nnz * d * k


def fused_step(n: int, d: int, s: int, k: int,
               y_res: bool) -> tuple[int, int]:
    """(bytes, operations) of kernel D's step: x, f_prev, the K DIA weight
    rows, y_res (kernel A's output, where there are residual edges), the
    row sums and deg + 1 and the s sample ids read once, x' and f written
    once; the n s sample pairs, a multiply-add per DIA offset and
    coordinate, y_res's add."""
    nbytes = (4 * n * (2 * d + k + (d if y_res else 0) + 2) + 4 * s
              + 4 * n * 2 * d)
    ops = n * s * pair_ops(d) + 2 * k * n * d + (n * d if y_res else 0)
    return nbytes, ops


def flat_iteration(n: int, nnz: int, d: int, s: int) -> tuple[int, int]:
    """(bytes, operations) of one flat ForceAtlas iteration with sampled
    repulsion on a unit-weight graph, whatever implements it: the CSR
    (int32 row pointers, which also give the degrees, and column ids), x,
    f_prev and the sample ids read once, x' and f written once.
    Operations: an add per entry and coordinate (A x), a multiply-add per
    vertex and coordinate (- deg x), the n s sample pairs, gravity (the
    norm, d - 1 adds and a square root, and a scaled division per
    coordinate: 3 d + 2) and the speed update (the swing and force norms,
    the speed, its bound, and a multiply-add per coordinate: 8 d + 8)."""
    nbytes = 4 * (n + 1) + 4 * nnz + 4 * d * n * 2 + 4 * s + 4 * d * n * 2
    ops = nnz * d + n * (2 * d + s * pair_ops(d) + 3 * d + 2 + 8 * d + 8)
    return nbytes, ops
