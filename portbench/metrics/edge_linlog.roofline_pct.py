"""Kernel E's share of its roofline over the profiled embed: each span's
kernel E calls times the least time of one call
(``roofline_linlog.edge_linlog``: the base case's CSR of
``base_attraction_entries`` over the coarsest level's vertices, or a
level's intra-aggregate CSR of ``ml_intra_entries``, counted in that
level's ``layout`` span), summed, over kernel E's device seconds.
Nothing to read from a program that counts neither; a span that ran
kernel E without a count of its entries fails the run."""

from portbench import roofline, roofline_linlog

COUNTS = ("base_attraction_entries", "ml_intra_entries")


def _count(sp, name):
    return sum(sub.get("counts", {}).get(name, 0)
               for sub in sp.get("sub", ()))


def read(rec):
    traced = [e for e in rec.get("embeds") or [] if e["traced"]]
    if "trace" not in rec or not any(_count(sp, c) for e in traced
                                     for sp in e["spans"] for c in COUNTS):
        return None
    least = seconds = 0.0
    for e in traced:
        intra = {sp["level"]: _count(sp, "ml_intra_entries")
                 for sp in e["spans"] if sp["phase"] == "layout"}
        for sp in e["spans"]:
            k = sp.get("kernels", {}).get("edge_linlog")
            if not k:
                continue
            nnz = (_count(sp, "base_attraction_entries")
                   if sp["phase"] == "base" else intra.get(sp.get("level")))
            if not nnz:
                raise RuntimeError(f"kernel E ran in a {sp['phase']} span "
                                   "with no count of its CSR's entries")
            least += k["calls"] * roofline.bound_s(
                *roofline_linlog.edge_linlog(sp["n"], sp["n"], nnz,
                                             rec["dim"]))
            seconds += k["seconds"]
    if seconds <= 0:
        return None
    return 100.0 * least / seconds
