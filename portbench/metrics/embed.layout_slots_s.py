"""Seconds of the program's ``layout.slots`` sub-spans (the host's part
of the layout prep before the attraction CSR: the level's COO on the
host, the vertex slots, the intra-aggregate degrees and folded weights),
summed over an embed's levels and averaged over the window's embeds."""

from portbench.metrics_common import _untraced


def read(rec):
    embeds = _untraced(rec)
    subs = [[sub["seconds"] for sp in e["spans"] if sp["phase"] == "layout"
             for sub in sp.get("sub", ()) if sub["name"] == "layout.slots"]
            for e in embeds]
    if not any(subs):
        return None
    return sum(sum(s) for s in subs) / len(subs)
