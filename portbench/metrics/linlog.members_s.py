"""Seconds of the program's ``ml.members`` sub-spans (the portable
refinement's member tables by size class, built on the host and
uploaded), summed over an embed's levels and averaged over the window's
embeds."""

from portbench.metrics_common import _untraced


def read(rec):
    subs = [[sub["seconds"] for sp in e["spans"]
             for sub in sp.get("sub", ()) if sub["name"] == "ml.members"]
            for e in _untraced(rec)]
    if not any(subs):
        return None
    return sum(sum(s) for s in subs) / len(subs)
