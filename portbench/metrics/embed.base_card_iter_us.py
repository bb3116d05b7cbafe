"""The card's microseconds per base-case iteration: the union of the
device intervals inside the profiled embed's ``base`` span (its
``busy_s``) over the iterations of its ``base.loop`` sub-span.  Beside
``embed.base_iter_us`` (the host's time per iteration) it is the least a
base case that keeps the card fed would take per iteration."""


def read(rec):
    per = []
    for e in rec.get("embeds") or []:
        if not e["traced"]:
            continue
        base = [sp for sp in e["spans"]
                if sp["phase"] == "base" and "busy_s" in sp]
        iters = sum(sub["iterations"] for sp in base
                    for sub in sp.get("sub", ()) if sub["name"] == "base.loop")
        if iters:
            per.append(1e6 * sum(sp["busy_s"] for sp in base) / iters)
    if "trace" not in rec or not per:
        return None
    return sum(per) / len(per)
