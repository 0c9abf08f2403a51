"""A run of each traffic driver on the CPU at a tiny size, with the card
check skipped: sound, ``correct`` comes out true; with the timed path
broken underneath, false. The faults are those each cell can have on one
chip: a step that returns its state unchanged, half of the batch left out,
an answer altered where it is produced."""
from __future__ import annotations

import pytest
import torch

import harness


def _correct(ctx) -> bool:
    outcome = harness.driver_module(ctx.cell.driver).run(ctx)
    line = harness.result_line(ctx.cell, outcome, False, {})
    assert list(line)[-1] == "checks"
    assert line["attempted"] > 0
    return line["correct"]


@pytest.fixture(autouse=True)
def _pil_decoder(monkeypatch):
    """The program decodes with PIL, as on the card's machine."""
    from touhouimageclassification_tpu_torch.data import native_loader
    monkeypatch.setattr(native_loader, "available", lambda: False)


@pytest.mark.parametrize("driver", ["train_step", "judge_sweep",
                                    "web_open_loop"])
def test_sound_run_is_correct(tiny, driver):
    assert _correct(tiny(driver))


def test_train_state_left_unchanged(tiny, monkeypatch):
    from touhouimageclassification_tpu_torch.train.optim import Optimizer
    monkeypatch.setattr(Optimizer, "update", lambda self, grads: False)
    assert not _correct(tiny("train_step"))


def test_train_half_batch_left_out(tiny, monkeypatch):
    from touhouimageclassification_tpu_torch.train import losses
    whole = losses.cross_entropy

    def half(logits, targets, sample_weights=None):
        n = logits.shape[0] // 2
        return whole(logits[:n], targets[:n])
    monkeypatch.setattr(losses, "cross_entropy", half)
    assert not _correct(tiny("train_step"))


def _serve_fault(monkeypatch, fault: str) -> None:
    from touhouimageclassification_tpu_torch.infer.serve import Predictor
    predict = Predictor._predict

    def altered(self, images):
        out = predict(self, images).clone()
        out[0] = (out[0] + 1) % 120
        return out

    def half(self, images):
        n = images.shape[0]
        h = max(1, n // 2)
        out = predict(self, images[:h])
        return torch.cat([out] * (n // h + 1), dim=1)[:, :n]
    monkeypatch.setattr(Predictor, "_predict",
                        altered if fault == "altered" else half)


@pytest.mark.parametrize("driver", ["judge_sweep", "web_open_loop"])
@pytest.mark.parametrize("fault", ["altered", "half_batch"])
def test_serving_faults(tiny, monkeypatch, driver, fault):
    _serve_fault(monkeypatch, fault)
    assert not _correct(tiny(driver))
