"""Megabytes of a card-only graph copied to the host per embed: the
program's ``graph_to_host_bytes`` counter (the COO of a graph without a
host copy, and each aggregate map without one, at every call), summed
over every record and sub-span of an embed and averaged over the
window's embeds.  Work that a cached host copy, or a layout built on the
card, drives to 0."""

from portbench.metrics_common import _untraced

COUNTER = "graph_to_host_bytes"


def _bytes(sp):
    return (sp.get("counts", {}).get(COUNTER, 0)
            + sum(_bytes(sub) for sub in sp.get("sub", ())))


def read(rec):
    embeds = _untraced(rec)
    per = [sum(_bytes(sp) for sp in e["spans"]) for e in embeds]
    if not any(per):
        return None
    return sum(per) / len(per) / 1e6
