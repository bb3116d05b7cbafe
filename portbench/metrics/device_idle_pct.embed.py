"""The card's idle share of an embed: 1 - (the union of its device
intervals inside the traced embed's spans) / (the whole seconds of the
window's embeds, which ran without the profiler, averaged; time between
spans included)."""

from portbench.metrics_common import embed_seconds, traced_busy


def read(rec):
    busy = traced_busy(rec)
    seconds = embed_seconds(rec)
    if busy is None or not seconds:
        return None
    return 100.0 * (1.0 - busy / seconds)
