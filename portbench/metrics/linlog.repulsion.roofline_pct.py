"""The portable refinement's within-aggregate repulsion, as a share of its
roofline: per level, the ``ml.loop`` sub-span's ``iterations`` times the
least time of one iteration's work (``roofline_linlog.member_repulsion``:
its ``ml_pairs`` member pairs, the level's coordinates read and forces
written once), summed, over the card's seconds of the work launched
inside the ``ml.repulsion`` sub-spans of the profiled embed (the driver's
``repulsion`` on each ``refine`` span)."""

from portbench import roofline, roofline_linlog


def read(rec):
    if "trace" not in rec:
        return None
    least = seconds = 0.0
    for e in rec.get("embeds") or []:
        if not e["traced"]:
            continue
        for sp in e["spans"]:
            if sp["phase"] != "refine" or "repulsion" not in sp:
                continue
            for sub in sp.get("sub", ()):
                pairs = sub.get("counts", {}).get("ml_pairs")
                if sub["name"] == "ml.loop" and pairs is not None:
                    least += sub["iterations"] * roofline.bound_s(
                        *roofline_linlog.member_repulsion(
                            sp["n"], rec["dim"], pairs))
            seconds += sp["repulsion"]["seconds"]
    if seconds <= 0 or least <= 0:
        return None
    return 100.0 * least / seconds
