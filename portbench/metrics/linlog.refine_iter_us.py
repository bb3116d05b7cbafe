"""Microseconds per iteration of the portable refinement: the program's
``ml.loop`` sub-spans (the iterations of every level, closed by a wait on
the stream) over their ``iterations``, per embed, averaged over the
window's embeds, which ran without the profiler."""

from portbench.metrics_common import _untraced


def read(rec):
    per = []
    for e in _untraced(rec):
        loops = [sub for sp in e["spans"] for sub in sp.get("sub", ())
                 if sub["name"] == "ml.loop"]
        iters = sum(sub["iterations"] for sub in loops)
        if iters:
            per.append(1e6 * sum(sub["seconds"] for sub in loops) / iters)
    return sum(per) / len(per) if per else None
