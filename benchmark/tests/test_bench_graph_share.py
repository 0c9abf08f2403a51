"""The readers of the share of training steps that replayed the step's
CUDA graph, on a hand-made record: two steps replayed, one eager."""
import importlib.util

import pytest

import harness
from touhouimageclassification_tpu_torch.utils import profiling


def _s(name, parent=None):
    return {"name": name, "id": 0, "parent": parent, "thread": 1,
            "start_ns": 0, "end_ns": 0, "host_ms": 1.0, "device_ms": None,
            "counts": {}}


RECORD = [_s("trainer.stage"), _s("trainer.step"), _s("trainer.inputs", 1),
          _s("trainer.fetch", 1),
          _s("trainer.stage"), _s("trainer.step"), _s("trainer.graph", 5),
          _s("trainer.fetch", 5), _s("trainer.forward", 5),
          _s("trainer.stage"), _s("trainer.step"), _s("trainer.graph", 10),
          _s("trainer.fetch", 10)]

METRICS = ["train.graph_share", "train_b8.graph_share"]


@pytest.mark.parametrize("metric", METRICS)
def test_share_of_steps_with_a_replay(metric, monkeypatch):
    monkeypatch.setattr(profiling, "recorded", lambda: RECORD)
    value = harness.metric_reader(metric).read({})
    assert value == pytest.approx(100.0 * 2 / 3)


@pytest.mark.parametrize("metric", METRICS)
def test_nothing_without_steps(metric, monkeypatch):
    monkeypatch.setattr(profiling, "recorded", lambda: [])
    assert harness.metric_reader(metric).read({}) is None


@pytest.mark.parametrize("metric", METRICS)
def test_nothing_from_a_port_without_a_step_graph(metric, monkeypatch):
    monkeypatch.setattr(profiling, "recorded", lambda: RECORD)
    reader = harness.metric_reader(metric)
    find = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name.endswith("step_graph")
                        else find(name, *a))
    assert reader.read({}) is None
