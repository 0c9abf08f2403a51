"""The readers of the port's span record (``utils.profiling.recorded``) on a
hand-made record: two training steps, two judge sweeps."""
import pytest

import harness
from touhouimageclassification_tpu_torch.utils import profiling


def _s(name, host_ms, parent=None, device_ms=None, **counts):
    return {"name": name, "id": 0, "parent": parent, "thread": 1,
            "start_ns": 0, "end_ns": int(host_ms * 1e6), "host_ms": host_ms,
            "device_ms": device_ms, "counts": counts}


def _step(first, host, inputs, norm, fetch, update):
    """A stage, then a step at index ``first + 1`` and its six phases:
    (host ms, device ms) pairs, the fetch host ms alone."""
    p = first + 1
    return [_s("trainer.stage", host[0]), _s("trainer.step", host[1]),
            _s("trainer.inputs", inputs[0], p, inputs[1]),
            _s("trainer.forward", 20.0, p, 30.0),
            _s("trainer.backward", 30.0, p, 50.0),
            _s("trainer.norm", norm[0], p, norm[1]),
            _s("trainer.fetch", fetch, p),
            _s("trainer.update", update[0], p, update[1])]


TRAIN = (_step(0, (4.0, 100.0), (5.0, 3.0), (15.0, 2.0), 25.0, (4.0, 6.0))
         + _step(8, (6.0, 120.0), (7.0, 5.0), (17.0, 4.0), 35.0, (6.0, 8.0)))

JUDGE = [
    _s("judge.sweep", 900.0, images=128, skipped=0),
    _s("judge.open", 300.0, 0),
    _s("judge.prep", 10.0, 0),
    _s("judge.fetch", 2.0, 2, hits=60, misses=4),
    _s("judge.decode", 5.0, 2),
    _s("judge.prep_wait", 20.0, 0),
    _s("judge.predict", 200.0, 0),
    _s("judge.prep", 10.0, 0),
    _s("judge.fetch", 2.0, 7, hits=64, misses=0),
    _s("judge.prep_wait", 30.0, 0),
    _s("judge.predict", 250.0, 0),
    _s("judge.sweep", 700.0, images=64, skipped=0),
    _s("judge.open", 500.0, 11),
    _s("judge.prep", 10.0, 11),
    _s("judge.fetch", 2.0, 13, hits=64, misses=0),
    _s("judge.prep_wait", 50.0, 11),
    _s("judge.predict", 300.0, 11),
]

EXPECTED = {
    "train.stage_ms": (TRAIN, (4 + 6) / 2),
    "train.fetch_wait_ms": (TRAIN, (25 + 35) / 2),
    "train.inputs_device_ms": (TRAIN, (3 + 5) / 2),
    "train.optimizer_device_ms": (TRAIN, (2 + 6 + 4 + 8) / 2),
    "train_b8.issue_ms": (TRAIN, (100 + 120 - 25 - 35) / 2),
    "train_b8.fetch_wait_ms": (TRAIN, (25 + 35) / 2),
    "train_b8.norm_ms": (TRAIN, (15 + 17) / 2),
    "train_b8.update_ms": (TRAIN, (4 + 6) / 2),
    "judge.open_ms": (JUDGE, (300 + 500) / 2),
    "judge.prep_wait_ms": (JUDGE, (20 + 30 + 50) / 2),
    "judge.predict_ms": (JUDGE, (200 + 250 + 300) / 2),
    "judge.cache_miss_share": (JUDGE, 100 * 4 / (64 + 64 + 64)),
}


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_on_a_synthetic_record(metric, monkeypatch):
    record, want = EXPECTED[metric]
    monkeypatch.setattr(profiling, "recorded", lambda: record)
    got = harness.metric_reader(metric).read({})
    assert got == pytest.approx(want)


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_on_an_empty_record(metric, monkeypatch):
    monkeypatch.setattr(profiling, "recorded", lambda: [])
    assert harness.metric_reader(metric).read({}) is None


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_of_a_port_without_spans(metric, monkeypatch):
    """A port that records no spans (an older commit) reads as nothing."""
    monkeypatch.delattr(profiling, "recorded")
    assert harness.metric_reader(metric).read({}) is None


def test_every_reader_is_listed_for_its_cell():
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    listed = {m["name"]: m["workloads"] for m in spec["per_layer"]}
    for metric in EXPECTED:
        cell = {"train.": "vitl-nvit-b256", "train_b8.": "vitl-nvit-b8",
                "judge.": "vitb-judge-sweep"}[metric.split(".")[0] + "."]
        assert listed[metric] == [cell]
