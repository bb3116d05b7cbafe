"""The whole flat iteration's share of the card's roofline: the least
time of one iteration's work (``roofline.flat_iteration``, counted from
the graph and the traffic, whatever implements the step) over the traced
window's seconds per iteration."""

from portbench import roofline


def read(rec):
    if "trace" not in rec or "nnz" not in rec:
        return None
    least = roofline.bound_s(*roofline.flat_iteration(
        rec["n"], rec["nnz"], rec["dim"], rec["samples"]))
    return 100.0 * least * rec["iterations"] / rec["window_s"]
