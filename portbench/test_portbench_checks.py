"""``correct`` comes out false for the control and for each fault the flat
cell can have, with the rest of a run as it is (on the CPU, at a small
size; the card's look is skipped)."""

from __future__ import annotations

import pytest
import torch

from portbench import control, harness
from portbench.conftest import make_checkout

SEED = 2**31 + 21


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_checkout(tmp_path_factory.mktemp("flat"),
                         [("lj-rmat24.flat", "lj-rmat24", "flat")],
                         {"lj-rmat24": {"scale": 15}})


def run(root):
    return harness.run_cell(root, "lj-rmat24.flat", SEED, 0.3, False, "cpu")


def test_sound_run_is_correct(root):
    line = run(root)
    assert line["correct"] and line["failed"] == 0


def test_control_is_not_correct(root):
    """The program's own bf16 gather (x_precision="bf16"), the nearest
    precision below the float32 the configuration states."""
    for line in control.readings(root, "lj-rmat24.flat", [SEED, SEED + 1,
                                                          SEED + 2], 0.3,
                                 device="cpu"):
        assert not line["correct"]
        assert line["checks"]["force_gap"]["value"] > \
            line["checks"]["force_gap"]["limit"]


def unchanged(x, f_prev, *a, **k):
    return x, f_prev


def altered(step):
    def fault(x, f_prev, *a, **k):
        x2, f = step(x, f_prev, *a, **k)
        # two vertices' answers written to each other's rows
        rows = torch.tensor([x.shape[0] // 3, x.shape[0] // 2])
        x2, f = x2.clone(), f.clone()
        x2[rows], f[rows] = x2[rows.flip(0)], f[rows.flip(0)]
        return x2, f
    return fault


def half_left_out(spmv):
    def fault(x, csr, **k):
        y = spmv(x, csr, **k).clone()
        y[: y.shape[0] // 2] = 0.0
        return y
    return fault


@pytest.mark.parametrize("fault", ["unchanged", "altered", "half"])
def test_fault_is_not_correct(root, fault, monkeypatch):
    from graph_embed_tpu_torch.forceatlas import tiled as TL

    if fault == "unchanged":
        # the step returns its state unchanged
        monkeypatch.setattr(TL, "fa_step_tiled", unchanged)
    elif fault == "altered":
        # one answer altered where it is produced
        monkeypatch.setattr(TL, "fa_step_tiled", altered(TL.fa_step_tiled))
    else:
        # kernel A's half of the rows left out
        monkeypatch.setattr(TL.ES, "spmv_windowed",
                            half_left_out(TL.ES.spmv_windowed))
    line = run(root)
    assert not line["correct"]
    assert line["failed"] > 0
    assert torch.isfinite(torch.tensor(
        [c["value"] for c in line["checks"].values()])).any()
