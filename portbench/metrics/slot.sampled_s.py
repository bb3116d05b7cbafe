"""Card seconds of the slot route's sampled within-aggregate repulsion:
the work launched inside the program's ``slot.sampled`` sub-spans of the
profiled embed (the driver's ``sampled`` on each ``refine`` span),
summed over its levels; None where no span has any."""


def read(rec):
    if "trace" not in rec:
        return None
    found = [sp["sampled"]["seconds"] for e in rec.get("embeds") or []
             if e["traced"] for sp in e["spans"] if "sampled" in sp]
    return sum(found) if found else None
