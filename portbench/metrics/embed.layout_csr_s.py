"""Seconds of the program's ``layout.csr`` sub-spans (the attraction
CSR of the level's slots: the host sort and the upload), summed over an
embed's levels and averaged over the window's embeds."""

from portbench.metrics_common import _untraced


def read(rec):
    embeds = _untraced(rec)
    subs = [[sub["seconds"] for sp in e["spans"] if sp["phase"] == "layout"
             for sub in sp.get("sub", ()) if sub["name"] == "layout.csr"]
            for e in embeds]
    if not any(subs):
        return None
    return sum(sum(s) for s in subs) / len(subs)
