"""The host's microseconds per base-case iteration: the program's
``base.loop`` sub-span (host clock around the flat layout's iteration
loop, no synchronize) over its ``iterations``, per embed, averaged over
the window's embeds, which ran without the profiler.  Beside
``embed.base_card_iter_us`` it is the host's lead over the card: a
launch-bound loop reads far above the card's time."""

from portbench.metrics_common import _untraced


def read(rec):
    per = []
    for e in _untraced(rec):
        loops = [sub for sp in e["spans"] if sp["phase"] == "base"
                 for sub in sp.get("sub", ()) if sub["name"] == "base.loop"]
        iters = sum(sub["iterations"] for sub in loops)
        if iters:
            per.append(1e6 * sum(sub["seconds"] for sub in loops) / iters)
    return sum(per) / len(per) if per else None
