"""The V-MoE cell and the loader cell on the CPU at a tiny size: a sound
run is correct; each fault the V-MoE cell's check must catch (capacity
halved, one choice a token, no router noise, half the batch left out of
the loss) and a loader whose canvases are not the files' makes it false.
The five ``vmoe.*`` readers on a hand-made record of two steps, and the
spans that a profiled V-MoE step records."""
from __future__ import annotations

import dataclasses

import pytest

import harness
from bench_tiny_moe import tiny_cell_context
from touhouimageclassification_tpu_torch.utils import profiling


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


@pytest.mark.parametrize("driver", ["train_step_moe", "train_loader"])
def test_sound_run_is_correct(tmp_path, driver):
    assert _correct(tiny_cell_context(driver, tmp_path))


def _config_fault(monkeypatch, **change):
    import moe_programs
    build = moe_programs.vmoe_config
    monkeypatch.setattr(moe_programs, "vmoe_config",
                        lambda cfg: dataclasses.replace(build(cfg), **change))


@pytest.mark.parametrize("fault", ["capacity_half", "k1", "no_noise",
                                   "half_batch"])
def test_vmoe_faults_are_caught(tmp_path, monkeypatch, fault):
    if fault == "capacity_half":
        from touhouimageclassification_tpu_torch.models.vmoe import MoEMlp
        capacity = MoEMlp.capacity
        monkeypatch.setattr(MoEMlp, "capacity",
                            lambda self, t: max(1, capacity(self, t) // 2))
    elif fault == "k1":
        _config_fault(monkeypatch, top_k=1)
    elif fault == "no_noise":
        _config_fault(monkeypatch, noise_std=0.0)
    else:
        from touhouimageclassification_tpu_torch.train import losses
        whole = losses.cross_entropy

        def half(logits, targets, sample_weights=None):
            n = logits.shape[0] // 2
            return whole(logits[:n], targets[:n])
        monkeypatch.setattr(losses, "cross_entropy", half)
    assert not _correct(tiny_cell_context("train_step_moe", tmp_path))


def test_loader_canvases_not_the_files_are_caught(tmp_path, monkeypatch):
    from touhouimageclassification_tpu_torch.data import loader
    decode = loader.decode_image
    monkeypatch.setattr(loader, "decode_image",
                        lambda path, canvas: decode(path, canvas)[:, ::-1])
    ctx = tiny_cell_context("train_loader", tmp_path)
    outcome = harness.driver_module("train_loader").run(ctx)
    checks = {name: (v, lim) for name, v, lim in outcome["checks"]}
    assert checks["canvas_gap"][0] > checks["canvas_gap"][1]
    assert not harness.verdict(outcome["checks"])


def _s(name, device_ms=None, parent=None, **counts):
    return {"name": name, "id": 0, "parent": parent, "thread": 1,
            "start_ns": 0, "end_ns": 0, "host_ms": 1.0,
            "device_ms": device_ms, "counts": counts}


def _step(kept, dropped, experts, route, dispatch, combine):
    """A step with two MoE layers: forward and backward spans of each."""
    out = [_s("trainer.step")]
    for layer in range(2):
        out += [_s("moe.route", route, 0, assignments=1000,
                   kept_held=kept[layer], dropped=dropped[layer],
                   load_max=1.2),
                _s("moe.dispatch", dispatch), _s("moe.experts", experts),
                _s("moe.combine", combine),
                _s("moe.combine", combine, backward=1),
                _s("moe.experts", 2 * experts, backward=1),
                _s("moe.dispatch", dispatch, backward=1),
                _s("moe.route", route, backward=1)]
    return out


RECORD = (_step((400, 450), (50, 30), 3.0, 0.5, 0.25, 0.75)
          + _step((420, 430), (10, 10), 5.0, 0.5, 0.25, 0.75))
SHAPE = {"hidden": 1024, "mlp": 4096, "image": 224, "patch": 16,
         "classes": 120, "layers": 24, "moe_layers": tuple(range(1, 24, 2)),
         "experts": 32}
READINGS = {"shape": SHAPE, "batch": 128, "images": 1280, "window_s": 2.0,
            "dense_flops_per_image": 1e11}


def _expected():
    from roofline import PEAK_BF16_FLOPS
    kept = 400 + 450 + 420 + 430
    per_slot = 2 * 2 * 1024 * 4096
    experts_s = 2 * (3 + 6) * 1e-3 + 2 * (5 + 10) * 1e-3
    flops = 3 * 1e11 * 1280 + 1280 / 128 * 3 * per_slot * kept / 2
    return {
        "vmoe.experts_device_ms": 2 * (3 + 6 + 5 + 10) / 2,
        "vmoe.route_dispatch_ms": 2 * 2 * (0.5 + 0.25 + 0.75) * 2 / 2,
        "vmoe.drop_share": 100 * (50 + 30 + 10 + 10) / 4000,
        "vmoe.experts_roofline": 100 * 3 * per_slot * kept / experts_s
        / PEAK_BF16_FLOPS,
        "vmoe.mfu": 100 * flops / 2.0 / PEAK_BF16_FLOPS,
    }


METRICS = sorted(_expected())


@pytest.mark.parametrize("metric", METRICS)
def test_reader_on_a_synthetic_record(metric, monkeypatch):
    monkeypatch.setattr(profiling, "recorded", lambda: RECORD)
    got = harness.metric_reader(metric).read(READINGS)
    assert got == pytest.approx(_expected()[metric])


@pytest.mark.parametrize("metric", METRICS)
def test_reader_on_an_empty_record(metric, monkeypatch):
    monkeypatch.setattr(profiling, "recorded", lambda: [])
    assert harness.metric_reader(metric).read(READINGS) is None


@pytest.mark.parametrize("metric", METRICS)
def test_reader_of_a_port_without_spans(metric, monkeypatch):
    monkeypatch.delattr(profiling, "recorded")
    assert harness.metric_reader(metric).read(READINGS) is None


def test_every_reader_is_listed_for_the_cell():
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    listed = {m["name"]: m for m in spec["per_layer"]}
    for metric in METRICS:
        assert listed[metric]["workloads"] == ["vmoe-l16-ep2-b128"]
        assert listed[metric]["moves"] == "train_img_per_s"


def test_a_profiled_step_gives_the_counts_readers(tmp_path, monkeypatch):
    """A profiled V-MoE step of the tiny cell's model on the CPU: its
    forward ``moe.route`` spans carry the counts that ``vmoe.drop_share``
    and ``vmoe.mfu`` read (the device readers find no device time on the
    CPU and give nothing)."""
    import numpy as np

    import moe_programs
    from moe_weights import make_vmoe_weights, vmoe_shape
    ctx = tiny_cell_context("train_step_moe", tmp_path)
    cfg, p = ctx.cell.config, ctx.cell.params
    shape = vmoe_shape(cfg)
    trainer, state = moe_programs.build_vmoe_trainer(
        cfg, p["preset"], p["batch"], ctx.seed,
        make_vmoe_weights(shape, ctx.seed, "cpu"), ctx.device, ctx.scratch)
    rng = np.random.default_rng(0)
    batch = {"image": rng.integers(0, 256, (4, 40, 40, 3), np.uint8),
             "label": np.arange(4)}
    profiling.clear()
    with profiling.trace(str(tmp_path / "trace")):
        for _ in range(2):
            trainer.train_step(state, trainer.stage(batch))
    spans = profiling.recorded()
    profiling.clear()
    monkeypatch.setattr(profiling, "recorded", lambda: spans)
    routes = [s["counts"] for s in spans
              if s["name"] == "moe.route" and "assignments" in s["counts"]]
    assert len(routes) == 2 * 2
    for c in routes:
        assert c["assignments"] == 2 * 2 * 2 * 17
        assert 0 < c["kept_held"] <= c["assignments"] - c["dropped"]
    readings = dict(READINGS, images=8, batch=4, shape=shape)
    share = harness.metric_reader("vmoe.drop_share").read(readings)
    assert share == pytest.approx(100 * sum(c["dropped"] for c in routes)
                                  / sum(c["assignments"] for c in routes))
    assert harness.metric_reader("vmoe.mfu").read(readings) > 0
    for metric in ("vmoe.experts_device_ms", "vmoe.route_dispatch_ms",
                   "vmoe.experts_roofline"):
        assert harness.metric_reader(metric).read(readings) is None
