"""What the per-layer readers share."""


def _untraced(rec):
    embeds = rec.get("embeds") or []
    return [e for e in embeds if not e["traced"]] or embeds


def span_seconds(rec, phase: str):
    """The seconds of ``phase``'s spans per embed, averaged over the
    record's embeds that ran without the profiler (all of them where
    none did); None where the record has no embeds or no such span."""
    embeds = _untraced(rec)
    if not any(sp["phase"] == phase for e in embeds for sp in e["spans"]):
        return None
    per = [sum(sp["seconds"] for sp in e["spans"] if sp["phase"] == phase)
           for e in embeds]
    return sum(per) / len(per)


def embed_seconds(rec):
    """The whole seconds of an embed, averaged over the record's embeds
    that ran without the profiler; None where it has none."""
    embeds = _untraced(rec)
    if not embeds:
        return None
    return sum(e["seconds"] for e in embeds) / len(embeds)


def traced_busy(rec, phase: str | None = None):
    """The card's busy seconds per traced embed inside its spans (only
    ``phase``'s, where given); None where no embed was profiled."""
    spans = [[sp for sp in e["spans"] if "busy_s" in sp
              and (phase is None or sp["phase"] == phase)]
             for e in rec.get("embeds") or [] if e["traced"]]
    spans = [s for s in spans if s]
    if "trace" not in rec or not spans:
        return None
    return sum(sp["busy_s"] for s in spans for sp in s) / len(spans)
