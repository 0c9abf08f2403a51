"""The port's spans (``utils/profiling.py``): off, they record nothing and
never enter ``record_function``; under ``torch.profiler`` a train step,
a k-step call and a judge sweep record their phases, nested and with their
counts, on the Chrome trace's clock, and the results are those of an
untraced run. The module imports nothing of JAX, so the card's test runs
with ``python -m pytest --noconftest tests/test_torch_tracing.py -m cuda``.
"""
import dataclasses
import json
import sys
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fixtures import make_image_folder
from touhouimageclassification_tpu_torch.config import PRESETS, ViTConfig
from touhouimageclassification_tpu_torch.data.folder import scan_image_folder
from touhouimageclassification_tpu_torch.infer import serve
from touhouimageclassification_tpu_torch.models.vit import ViT
from touhouimageclassification_tpu_torch.train.trainer import Trainer
from touhouimageclassification_tpu_torch.utils import profiling

torch.set_num_threads(1)

# head dim 32, the smallest the card's attention kernels take
TINY = ViTConfig(image_size=32, patch_size=8, hidden_size=64, num_layers=2,
                 num_heads=2, mlp_dim=128, num_classes=4)
STEP_CHILDREN = ["trainer.inputs", "trainer.forward", "trainer.backward",
                 "trainer.norm", "trainer.fetch", "trainer.update"]


@pytest.fixture(autouse=True)
def empty_record():
    profiling.clear()
    yield
    profiling.clear()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _trainer(tmp_path, device="cpu", seed=0):
    cfg = dataclasses.replace(PRESETS["nvit"], global_batch_size=4, seed=seed,
                              log_dir=str(tmp_path / "log"))
    model = ViT(TINY, "float32", device, param_dtype="float32", seed=0)
    trainer = Trainer(cfg, model=model, device=device)
    return trainer, trainer.init_state()


def _batches(n, rows=4, side=40, seed=0):
    rng = np.random.default_rng(seed)
    return [{"image": rng.integers(0, 256, (rows, side, side, 3), np.uint8),
             "label": rng.integers(0, TINY.num_classes, rows)}
            for _ in range(n)]


def _named(spans, name):
    return [s for s in spans if s["name"] == name]


def test_off_records_nothing_and_never_enters_record_function(tmp_path,
                                                              monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with tracing off")

    monkeypatch.setattr(profiling, "record_function", refuse)
    trainer, state = _trainer(tmp_path)
    trainer.train_step(state, trainer.stage(_batches(1)[0]))
    assert profiling.recorded() == [] and profiling.dropped() == 0


def test_off_returns_one_shared_object_and_keeps_no_memory():
    first = profiling.span("trainer.step", id=3, rows=8)
    assert profiling.span("judge.sweep") is first
    with first as handle:
        handle.set(rows=9)
    before = sys.getallocatedblocks()
    for _ in range(10_000):
        with profiling.span("trainer.fetch") as s:
            s.set(hits=1)
    # nothing is kept a call (stray blocks of the interpreter's own aside)
    assert sys.getallocatedblocks() - before < 100
    assert profiling.recorded() == []


def test_train_step_records_its_six_phases_in_order(tmp_path):
    trainer, state = _trainer(tmp_path)
    batch = trainer.stage(_batches(1)[0])
    state.step = 5
    with _cpu_profile():
        trainer.train_step(state, batch)
    spans = profiling.recorded()
    steps = _named(spans, "trainer.step")
    assert len(steps) == 1 and steps[0]["parent"] is None
    assert steps[0]["id"] == 5 and steps[0]["counts"] == {"rows": 4}
    root = spans.index(steps[0])
    children = [s for s in spans if s["parent"] == root]
    assert [s["name"] for s in children] == STEP_CHILDREN
    assert all(s["id"] == 5 for s in children)
    for a, b in zip(children, children[1:]):
        assert a["end_ns"] <= b["start_ns"]
    assert all(steps[0]["start_ns"] <= s["start_ns"] <= s["end_ns"]
               <= steps[0]["end_ns"] for s in children)
    # on the CPU no span has device time
    assert all(s["device_ms"] is None for s in spans)


def test_stage_records_rows_and_bytes(tmp_path):
    trainer, _ = _trainer(tmp_path)
    batch = _batches(1)[0]
    with _cpu_profile():
        trainer.stage(batch)
    (stage,) = profiling.recorded()
    assert stage["name"] == "trainer.stage" and stage["parent"] is None
    assert stage["counts"] == {
        "rows": 4, "bytes": batch["image"].nbytes + batch["label"].nbytes}


def test_k_step_call_records_k_steps_and_one_fetch(tmp_path):
    trainer, state = _trainer(tmp_path)
    batches = [trainer.stage(b) for b in _batches(4)]
    with _cpu_profile():
        trainer.train_steps(state, batches)
    spans = profiling.recorded()
    steps = _named(spans, "trainer.step")
    assert [s["id"] for s in steps] == [0, 1, 2, 3]
    assert all(s["parent"] is None for s in steps)
    fetches = _named(spans, "trainer.fetch")
    assert len(fetches) == 1 and fetches[0]["parent"] is None
    assert fetches[0]["start_ns"] >= steps[-1]["end_ns"]
    for name in STEP_CHILDREN:
        if name != "trainer.fetch":
            assert len(_named(spans, name)) == 4


def test_tracing_leaves_the_parameters_bit_equal(tmp_path):
    batches = _batches(3)
    params = []
    for traced in (False, True):
        trainer, state = _trainer(tmp_path / str(traced))
        with _cpu_profile() if traced else torch.no_grad():
            for b in batches:
                with torch.enable_grad():
                    trainer.train_step(state, trainer.stage(b))
        params.append({k: v.detach().clone()
                       for k, v in state.model.named_parameters()})
    assert len(_named(profiling.recorded(), "trainer.step")) == 3
    for k, v in params[0].items():
        assert torch.equal(v, params[1][k]), k


def test_spans_share_the_chrome_trace_clock(tmp_path):
    trainer, state = _trainer(tmp_path)
    with _cpu_profile() as prof:
        trainer.train_step(state, trainer.stage(_batches(1)[0]))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base_us = trace.get("baseTimeNanoseconds", 0) / 1e3
    events = {}
    for e in trace["traceEvents"]:
        if e.get("ph") == "X" and e.get("name", "").startswith("tic."):
            events.setdefault(e["name"], []).append(e)
    spans = profiling.recorded()
    assert len(spans) == 8
    for s in spans:
        (e,) = events["tic." + s["name"]]
        start = profiling.unix_us(s["start_ns"]) - base_us
        end = profiling.unix_us(s["end_ns"]) - base_us
        assert abs(start - e["ts"]) < 1000, s["name"]
        assert abs(end - (e["ts"] + e["dur"])) < 1000, s["name"]


def test_record_is_capped_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiling, "CAPACITY", 5)
    with _cpu_profile():
        for i in range(8):
            with profiling.span("judge.csv", rows=i):
                pass
    spans = profiling.recorded()
    assert [s["counts"]["rows"] for s in spans] == [0, 1, 2, 3, 4]
    assert profiling.dropped() == 3
    profiling.clear()
    assert profiling.recorded() == [] and profiling.dropped() == 0


def test_counts_set_inside_a_span_and_parent_across_threads():
    import threading

    with _cpu_profile():
        with profiling.span("judge.sweep", images=0) as sweep:
            sweep.set(images=12)

            def prep():
                with profiling.span("judge.prep", parent=sweep):
                    pass

            worker = threading.Thread(target=prep)
            worker.start()
            worker.join(timeout=30)
    assert not worker.is_alive()
    sweep_rec, prep = profiling.recorded()
    assert sweep_rec["counts"] == {"images": 12}
    assert prep["parent"] == 0 and prep["id"] == sweep_rec["id"]
    assert prep["thread"] != sweep_rec["thread"]


@pytest.fixture(scope="module")
def judge_folder(tmp_path_factory):
    return make_image_folder(str(tmp_path_factory.mktemp("tracing_data")),
                             num_classes=TINY.num_classes, per_class=5,
                             size=40)


def _predictor(folder):
    model = ViT(TINY, "float32", "cpu", param_dtype="float32", seed=0)
    return serve.Predictor(model=model,
                           class_to_idx=scan_image_folder(folder).class_to_idx,
                           image_size=(32, 32), mean=np.full(3, 0.5),
                           std=np.full(3, 0.25), device=torch.device("cpu"))


def _judge_spans(spans):
    sweep = spans.index(_named(spans, "judge.sweep")[0])
    kids = lambda i: [s["name"] for s in spans if s["parent"] == i]  # noqa: E731
    return sweep, kids


@pytest.mark.parametrize("cache", ["on", "off"])
def test_judge_spans_nest_under_their_sweep(judge_folder, tmp_path, cache):
    predictor = _predictor(judge_folder)
    with _cpu_profile():
        serve.full_judge(predictor, judge_folder, str(tmp_path / "a.csv"),
                         batch_size=8, progress=False, canvas_cache=cache)
    spans = profiling.recorded()
    assert len(_named(spans, "judge.sweep")) == 1
    sweep, kids = _judge_spans(spans)
    batches = 3  # 20 images at 8 a batch
    main = kids(sweep)
    assert main[0] == "judge.open"
    assert main.count("judge.prep_wait") == main.count("judge.predict") \
        == main.count("judge.csv") == main.count("judge.prep") == batches
    assert main[-1] == ("judge.flush" if cache == "on" else "judge.csv")
    assert spans[sweep]["counts"] == {"images": 20, "skipped": 0}
    assert all(s["id"] == spans[sweep]["id"] for s in spans)
    preps = [i for i, s in enumerate(spans) if s["name"] == "judge.prep"]
    assert all(spans[i]["thread"] != spans[sweep]["thread"] for i in preps)
    inner = ["judge.fetch", "judge.decode", "predict.stage"] if cache == "on" \
        else ["judge.decode", "predict.stage"]
    assert all(kids(i) == inner for i in preps)
    for i, s in enumerate(spans):
        if s["name"] == "judge.predict":
            assert kids(i) == ["predict.forward", "predict.fetch"]
    stages = _named(spans, "predict.stage")
    assert [s["counts"]["rows"] for s in stages] == [8, 8, 4]
    assert {s["counts"]["bucket"] for s in stages} == {8}


def test_judge_fetch_counts_misses_cold_and_hits_warm(tmp_path):
    folder = make_image_folder(str(tmp_path / "d"),
                               num_classes=TINY.num_classes, per_class=5,
                               size=40)
    predictor = _predictor(folder)
    counts = []
    for _ in range(2):
        profiling.clear()
        with _cpu_profile():
            serve.full_judge(predictor, folder, None, batch_size=8,
                             progress=False, canvas_cache="on")
        fetches = _named(profiling.recorded(), "judge.fetch")
        counts.append((sum(f["counts"]["hits"] for f in fetches),
                       sum(f["counts"]["misses"] for f in fetches)))
    assert counts == [(0, 20), (20, 0)]
    assert not _named(profiling.recorded(), "judge.decode")


def test_judge_csv_is_byte_equal_traced_and_not(judge_folder, tmp_path):
    predictor = _predictor(judge_folder)
    off, on = tmp_path / "off.csv", tmp_path / "on.csv"
    serve.full_judge(predictor, judge_folder, str(off), batch_size=8,
                     progress=False, canvas_cache="off")
    assert profiling.recorded() == []
    with _cpu_profile():
        serve.full_judge(predictor, judge_folder, str(on), batch_size=8,
                         progress=False, canvas_cache="off")
    assert profiling.recorded()
    assert on.read_bytes() == off.read_bytes()


def test_predict_array_records_stage_forward_and_one_fetch(judge_folder):
    predictor = _predictor(judge_folder)
    images = np.zeros((70, 32, 32, 3), np.uint8)
    with _cpu_profile():
        predictor.predict_array(images)
    names = [s["name"] for s in profiling.recorded()]
    assert names == ["predict.stage", "predict.forward"] * 2 \
        + ["predict.fetch"]


def test_trace_writes_the_spans_beside_the_chrome_trace(tmp_path):
    profiling.clear()
    with profiling.trace(str(tmp_path / "prof")):
        with profiling.span("trainer.step", id=7):
            pass
    files = sorted(p.name for p in (tmp_path / "prof").iterdir())
    assert [f.split(".")[0] for f in files] == ["spans", "trace"]
    written = json.loads((tmp_path / "prof" / files[0]).read_text())
    assert written["dropped"] == 0 and len(written["clock_ns"]) == 2
    assert [(s["name"], s["id"]) for s in written["spans"]] == [
        ("trainer.step", 7)]


@pytest.mark.cuda
@pytest.mark.parametrize("graphed", [False, True], ids=["eager", "graph"])
def test_device_ms_lies_inside_the_host_interval_and_its_queue(tmp_path,
                                                               graphed):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    trainer, state = _trainer(tmp_path, device=dev)
    trainer._graphable = graphed
    batches = [trainer.stage(b) for b in _batches(3)]
    trainer.train_step(state, batches[0])  # builds the kernels
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for b in batches[1:]:
            trainer.train_step(state, b)
        torch.cuda.synchronize()
        drained = time.perf_counter_ns()
    spans = profiling.recorded()
    timed = [s for s in spans if s["device_ms"] is not None]
    phases = {"trainer.inputs", "trainer.forward", "trainer.backward",
              "trainer.norm"}
    graphs = _named(spans, "trainer.graph")
    assert len(graphs) == (2 if graphed else 0)
    assert {s["name"] for s in timed} == phases | {"trainer.update"} | {
        s["name"] for s in graphs}
    for graph in graphs:
        # the two steps after the first replay a captured graph: its phases
        # are timed by the graph's own events, inside the replay's device
        # time
        inside = [s["device_ms"] for s in timed
                  if s["id"] == graph["id"] and s["name"] in phases]
        assert len(inside) == 4 and 0 < sum(inside) <= graph["device_ms"]
    fetched = [s["end_ns"] for s in _named(spans, "trainer.fetch")]
    for s in (s for s in timed if not (graphed and s["name"] in phases)):
        # the span's events ran on the stream between its start on the host
        # and the next time the host waited for the stream to drain (a
        # step's fetch, or the synchronisation above)
        until = min([t for t in fetched if t >= s["end_ns"]] + [drained])
        assert 0 < s["device_ms"] <= (until - s["start_ns"]) / 1e6, s["name"]
