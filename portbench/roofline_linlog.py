"""Operations and bytes of the LinLog embed's two kernels of record (plain
arithmetic, held to ``roofline.py``'s peaks): kernel E's LinLog
attraction and the portable refinement's within-aggregate repulsion.
Each input byte is counted read once and each output byte written once,
and the repulsion counts the member pairs and not the tables' padding,
so any later kernel is held to the same yardstick.
"""

from __future__ import annotations

from portbench.roofline import pair_ops


def linlog_entry_ops(d: int) -> int:
    """Operations of one LinLog attraction entry: d differences, d
    products and d - 1 sums for d^2, the square root, log1p, the
    division by d, the product with the weight and ``attract`` (2), and
    d multiply-adds (2 d)."""
    return 5 * d + 4


def edge_linlog(n_rows: int, n_cols: int, nnz: int,
                d: int) -> tuple[int, int]:
    """(bytes, operations) of one kernel E call: int32 row pointers,
    column ids and float32 weights, every row of x read once, the forces
    written once; ``linlog_entry_ops`` per entry."""
    nbytes = 4 * (n_rows + 1) + 8 * nnz + 4 * d * (n_cols + n_rows)
    return nbytes, nnz * linlog_entry_ops(d)


def member_repulsion(n: int, d: int, pairs: int) -> tuple[int, int]:
    """(bytes, operations) of one iteration's within-aggregate repulsion
    over a level of ``n`` vertices: the member coordinates read once and
    the forces written once, ``pair_ops`` per ordered member pair."""
    return 8 * n * d, pairs * pair_ops(d)
