"""The reader of AdamW's share of its bytes bound
(``metrics/train.update_roofline.py``) on hand-made span records and trace
reductions."""
import pytest

import harness
from touhouimageclassification_tpu_torch.utils import profiling

METRIC = "train.update_roofline"


def _update(device_ms, **counts):
    return {"name": "trainer.update", "id": 0, "parent": 0, "thread": 1,
            "start_ns": 0, "end_ns": 1, "host_ms": 0.5,
            "device_ms": device_ms, "counts": counts}


def _trace(count, seconds, name="adamw_kernel(Entry const*, int, long "
           "long, Hyper)"):
    """A traced window's reduction holding ``count`` launches of ``name``
    beside one of another kernel."""
    return {"trace": {"kernels": {
        name: {"count": count, "seconds": seconds},
        "void at::native::vectorized_elementwise_kernel": {"count": 9,
                                                           "seconds": 0.5}}}}


def test_bytes_of_the_elements_written_over_the_update_device_time(
        monkeypatch):
    # two ViT-L updates of 304.5 M elements, their kernels 3 ms each: 28 B
    # an element; the spans' own device time (13 ms, the host's work before
    # the launch included) is not read
    record = [{"name": "trainer.step", "id": 0, "parent": None, "thread": 1,
               "start_ns": 0, "end_ns": 1, "host_ms": 30.0, "device_ms": None,
               "counts": {}},
              _update(13.0, elements=304_500_000, launches=1),
              _update(13.0, elements=304_500_000, launches=1)]
    monkeypatch.setattr(profiling, "recorded", lambda: record)
    got = harness.metric_reader(METRIC).read(_trace(2, 6e-3))
    assert got == pytest.approx(100 * 28 * 304.5e6 / 3.35e12 / 3e-3)


def test_a_launch_the_trace_missed_leaves_the_reading(monkeypatch):
    # eight V-MoE updates, the trace holding seven of their kernels at
    # 18 ms: the elements of a launch over the time of a launch
    record = [_update(19.0, elements=1_814_688_888, launches=1)] * 8
    monkeypatch.setattr(profiling, "recorded", lambda: record)
    got = harness.metric_reader(METRIC).read(_trace(7, 7 * 18e-3))
    assert got == pytest.approx(100 * 28 * 1_814_688_888 / 3.35e12 / 18e-3)


@pytest.mark.parametrize("record, readings", [
    ([], _trace(1, 3e-3)),
    ([_update(13.0)], _trace(1, 3e-3)),           # an update that counts none
    ([_update(13.0, elements=10, launches=1)], {}),           # no trace
    ([_update(13.0, elements=10, launches=1)],    # no kernel of the update
     _trace(1, 3e-3, name="multi_tensor_apply_kernel")),
    ([_update(13.0, elements=10, launches=1)], _trace(1, 0.0)),
    ([_update(13.0, elements=10)], _trace(1, 3e-3)),      # no launch counted
])
def test_reads_nothing_without_counted_and_timed_updates(record, readings,
                                                         monkeypatch):
    monkeypatch.setattr(profiling, "recorded", lambda: record)
    assert harness.metric_reader(METRIC).read(readings) is None


def test_a_port_without_spans_reads_nothing(monkeypatch):
    monkeypatch.delattr(profiling, "recorded")
    assert harness.metric_reader(METRIC).read(_trace(1, 3e-3)) is None


def test_listed_for_the_adamw_cells_that_report_train_img_per_s():
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    entry = next(m for m in spec["per_layer"] if m["name"] == METRIC)
    assert entry["workloads"] == ["vitl-nvit-b256", "vmoe-l16-ep2-b128"]
    assert entry["moves"] == "train_img_per_s"
