"""The card's idle share of the traced flat window: 1 - (the union of
its device intervals) / (the window's host seconds)."""


def read(rec):
    if "trace" not in rec or "plan" not in rec:
        return None
    return 100.0 * (1.0 - rec["trace"]["busy_s"] / rec["window_s"])
