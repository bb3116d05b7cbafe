"""Kernel A's share of its roofline: the residual CSR's SpMV bytes and
operations (``roofline.spmv``, unit weights) over kernel A's device time
per call.  Nothing to read where the plan left kernel A no edges; a plan
with residual edges whose trace names no kernel A fails the run."""

from portbench import roofline


def read(rec):
    plan = rec.get("plan")
    if "trace" not in rec or not plan or not plan["residual_nnz"]:
        return None
    k = rec["trace"]["kernels"].get("edge_spmm")
    if not k or k["seconds"] <= 0:
        raise RuntimeError("the plan has residual edges but the trace "
                           "shows no kernel A (edge_spmm)")
    least = roofline.bound_s(*roofline.spmv(
        rec["n"], rec["n"], plan["residual_nnz"], rec["dim"]))
    return 100.0 * least * k["calls"] / k["seconds"]
