"""The card's busy share of the base case: the union of its device
intervals inside the traced embed's ``base`` spans (profiled span by
span) over the ``base`` seconds of the window's embeds, which ran without
the profiler.  The profiler's cost per launch stretches the traced span
itself by half or more, so its own seconds would read the share low.
Low means the launch-bound base case leaves the card idle."""

from portbench.metrics_common import span_seconds, traced_busy


def read(rec):
    busy = traced_busy(rec, "base")
    seconds = span_seconds(rec, "base")
    if busy is None or not seconds:
        return None
    return 100.0 * busy / seconds
