"""Seconds of the embed's ``layout`` spans (the program's
``MetricsLogger`` spans, host clock closed by a synchronize), summed
per embed and averaged over the window's embeds."""

from portbench.metrics_common import span_seconds


def read(rec):
    return span_seconds(rec, "layout")
