"""Kernel D's share of its roofline: the fused step's bytes and
operations (``roofline.fused_step``: the plan's DIA offsets, kernel A's
output where there are residual edges, the sample pairs) over kernel D's
device time per call.  A flat trace that shows no kernel D fails the
run."""

from portbench import roofline


def read(rec):
    plan = rec.get("plan")
    if "trace" not in rec or not plan:
        return None
    k = rec["trace"]["kernels"].get("fused_step")
    if not k or k["seconds"] <= 0:
        raise RuntimeError("the flat trace shows no kernel D (fused_step)")
    least = roofline.bound_s(*roofline.fused_step(
        rec["n"], rec["dim"], rec["samples"], plan["dia_offsets"],
        plan["residual_nnz"] > 0))
    return 100.0 * least * k["calls"] / k["seconds"]
