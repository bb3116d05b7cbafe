"""Kernel B on the slot route as a share of its roofline: per level of the
profiled embed, the least time of its work
(``roofline_linlog.member_repulsion``: the level's ``slot_pairs`` ordered
member pairs of the exact aggregates, summed over the iterations, and
their members' coordinates read and forces written once an iteration),
summed, over kernel B's card seconds in the ``refine`` spans (the
driver's ``kernel_b``).  The exact members of a level are its vertices
less those of the sampled aggregates (``slot_sampled_pairs`` over the
samples and the iterations)."""

from portbench import roofline, roofline_linlog


def read(rec):
    if "trace" not in rec:
        return None
    least = seconds = 0.0
    d, iters = rec["dim"], rec["refine_iterations"]
    for e in rec.get("embeds") or []:
        if not e["traced"]:
            continue
        for sp in e["spans"]:
            counts = sp.get("counts", {})
            if (sp["phase"] != "refine" or "kernel_b" not in sp
                    or "slot_pairs" not in counts):
                continue
            members = sp["n"] - counts.get("slot_sampled_pairs", 0) // (
                rec["samples"] * iters)
            nbytes, ops = roofline_linlog.member_repulsion(
                members, d, counts["slot_pairs"])
            least += roofline.bound_s(nbytes * iters, ops)
            seconds += sp["kernel_b"]["seconds"]
    if seconds <= 0 or least <= 0:
        return None
    return 100.0 * least / seconds
