"""The slot route's sampled within-aggregate repulsion as a share of its
roofline: the least time of its work, summed over the profiled embed's
levels, over the card's seconds of the work launched inside the
program's ``slot.sampled`` sub-spans (the driver's ``sampled``).

The work of a level is counted from its ``slot_sampled_pairs`` (members
of the sampled aggregates times the K samples, summed over the
iterations): ``roofline.pair_ops`` operations a (member, sample) pair,
and each member's coordinates read and force written once an iteration,
8 d bytes a member, so 8 d / K bytes a pair (the uniforms and the
partners' gathers left out, so the time is a floor)."""

from portbench import roofline


def sampled_work(pairs: int, d: int, samples: int) -> tuple[float, float]:
    """(bytes, operations) of ``pairs`` (member, sample) pairs."""
    return 8.0 * d * pairs / samples, float(pairs * roofline.pair_ops(d))


def read(rec):
    if "trace" not in rec:
        return None
    least = seconds = 0.0
    for e in rec.get("embeds") or []:
        if not e["traced"]:
            continue
        for sp in e["spans"]:
            if "sampled" not in sp:
                continue
            pairs = sp.get("counts", {}).get("slot_sampled_pairs", 0)
            least += roofline.bound_s(*sampled_work(pairs, rec["dim"],
                                                    rec["samples"]))
            seconds += sp["sampled"]["seconds"]
    if seconds <= 0 or least <= 0:
        return None
    return 100.0 * least / seconds
