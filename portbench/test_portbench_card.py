"""On the card (marker ``cuda``; skipped elsewhere): a small flat cell
through the harness, traced, and its control.

    python -m pytest -p no:cacheprovider portbench/test_portbench_card.py
"""

from __future__ import annotations

import pytest

from portbench import control, harness
from portbench.conftest import make_checkout
from portbench.test_portbench_harness import FLAT_METRICS, check_line


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    return make_checkout(tmp_path_factory.mktemp("card"),
                         [("lj-rmat24.flat", "lj-rmat24", "flat")],
                         {"lj-rmat24": {"scale": 16}},
                         [(m, ["lj-rmat24.flat"], "fa_entries_per_s")
                          for m in FLAT_METRICS])


@pytest.mark.cuda
def test_small_flat_cell_on_the_card(card, small):
    line = harness.run_cell(small, "lj-rmat24.flat", 2**31 + 41, 1, False,
                            card)
    check_line(line)
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert line["device"]["memory_peak_bytes"] > 0
    traced = harness.run_cell(small, "lj-rmat24.flat", 2**31 + 42, 1, True,
                              card)
    check_line(traced)
    assert traced["correct"]
    assert set(traced["metrics"]) == set(FLAT_METRICS)
    for name, m in traced["metrics"].items():
        assert 0 < m["value"] <= 105, (name, m)
    dev = traced["device"]
    assert 0 < dev["busy_s"] <= dev["window_s"] * 1.01
    assert "edge_spmm" in dict(traced["breakdown"]["device_ops"])


@pytest.mark.cuda
def test_control_on_the_card(card, small):
    for line in control.readings(small, "lj-rmat24.flat",
                                 [2**31 + 43, 2**31 + 44, 2**31 + 45], 1,
                                 device=card):
        assert not line["correct"]
