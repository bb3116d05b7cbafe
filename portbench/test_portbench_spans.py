"""The readers of the program's sub-spans and counters on made-up
records: each takes what it names from the window's unprofiled embeds
(the base case's card time from the profiled one) and returns None where
the record lacks the sub-span or counter, as a parent's records do."""

from __future__ import annotations

import pytest

from portbench import harness
from portbench.conftest import ROOT


def reader(name):
    return harness.load_module(ROOT, "metrics", name).read


def sub(name, seconds, **fields):
    return {"name": name, "seconds": seconds, "t0_ns": 0, "t1_ns": 1,
            "parent": None, **fields}


def embed(traced, spans, seconds=10.0):
    return {"seconds": seconds, "traced": traced, "spans": spans}


def layout(level, slots, csr, copied=0):
    sp = {"phase": "layout", "seconds": slots + csr + 0.1, "level": level,
          "sub": [sub("layout.slots", slots), sub("layout.csr", csr)]}
    if copied:
        sp["sub"][0]["counts"] = {"graph_to_host_bytes": copied}
    return sp


@pytest.fixture
def rec():
    base = {"phase": "base", "seconds": 8.0,
            "sub": [sub("base.loop", 7.5, iterations=10_000)]}
    return {"trace": {"busy_s": 2.0, "window_s": 30.0},
            "embeds": [
                embed(False, [
                    {"phase": "galerkin", "seconds": 1.0,
                     "counts": {"graph_to_host_bytes": 300}},
                    base, layout(1, 0.25, 0.5), layout(0, 1.0, 0.75, 250)]),
                embed(False, [
                    {"phase": "galerkin", "seconds": 1.0,
                     "counts": {"graph_to_host_bytes": 300}},
                    {**base, "sub": [sub("base.loop", 8.5,
                                         iterations=10_000)]},
                    layout(1, 0.75, 0.5), layout(0, 2.0, 1.25, 250)]),
                embed(True, [
                    {**base, "seconds": 15.0, "busy_s": 0.9,
                     "sub": [sub("base.loop", 14.0, iterations=10_000)]},
                    {**layout(0, 9.0, 9.0, 999), "busy_s": 0.1}], 30.0)]}


def test_base_case_per_iteration_host_and_card(rec):
    assert reader("embed.base_iter_us")(rec) == pytest.approx(800.0)
    assert reader("embed.base_card_iter_us")(rec) == pytest.approx(90.0)


def test_layout_sub_spans_sum_over_levels(rec):
    assert reader("embed.layout_slots_s")(rec) == pytest.approx(2.0)
    assert reader("embed.layout_csr_s")(rec) == pytest.approx(1.5)


def test_graph_bytes_sum_over_records_and_sub_spans(rec):
    # 300 on the phase, 250 on a sub-span, per unprofiled embed
    assert reader("embed.graph_to_host_mb")(rec) == pytest.approx(550e-6)


@pytest.mark.parametrize("name", [
    "embed.base_iter_us", "embed.base_card_iter_us", "embed.layout_slots_s",
    "embed.layout_csr_s", "embed.graph_to_host_mb"])
def test_none_without_the_sub_span_or_counter(rec, name):
    """A record from a program without the sub-spans and counters (a
    parent's) reads None, as does one without embeds."""
    for e in rec["embeds"]:
        for sp in e["spans"]:
            sp.pop("sub", None)
            sp.pop("counts", None)
    assert reader(name)(rec) is None
    assert reader(name)({"embeds": []}) is None


def test_card_time_needs_the_trace(rec):
    rec.pop("trace")
    assert reader("embed.base_card_iter_us")(rec) is None
    assert reader("embed.base_iter_us")(rec) == pytest.approx(800.0)
