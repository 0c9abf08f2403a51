"""The train step replayed as one CUDA graph (``train/step_graph.py`` and
``Trainer.train_step``).

On the CPU: the mix whose draw is a device vector equals the host draw's
mix; the step stays eager on the CPU, in k-step calls and in a run of
several processes; a shape's first step warms it and its second captures,
once; a capture that raises falls back to eager once, for good; the launch
counters take a capture's launches back and credit each replay with them;
a replayed phase is recorded with its device time alone; the step's four
phases go to the graph's spans while it is captured.

On the card (marked ``cuda``; the module imports nothing of JAX, so
``python -m pytest --noconftest tests/test_torch_step_graph.py -m cuda``
runs them there): ``nvit`` steps at batch 8 on the graph against eager
steps, bit for bit, and so ResNet steps with each BatchNorm variant and
ResMoE steps, and V-MoE steps (their routing, experts and combine
recorded into the graph and read after each profiled replay); K1 and K2
counted per replay; a non-finite batch skipped
under the graph; a second batch shape in the shared pool; a capture that
raises.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from touhouimageclassification_tpu_torch.config import PRESETS, ViTConfig
from touhouimageclassification_tpu_torch.models import create_model
from touhouimageclassification_tpu_torch.models.resnet import BN_VARIANTS
from touhouimageclassification_tpu_torch.models.vit import ViT
from touhouimageclassification_tpu_torch.models.vmoe import VMoE, VMoEConfig
from touhouimageclassification_tpu_torch.ops import attention, patch_embed
from touhouimageclassification_tpu_torch.ops.mixup import (
    apply_cutmix_or_mixup, apply_mix_params, mix_params)
from touhouimageclassification_tpu_torch.train import step_graph
from touhouimageclassification_tpu_torch.train import trainer as trainer_mod
from touhouimageclassification_tpu_torch.train.tasks import MoETask, VMoETask
from touhouimageclassification_tpu_torch.train.trainer import (
    ClassificationTask, Trainer)
from touhouimageclassification_tpu_torch.utils import profiling

torch.set_num_threads(1)

# head dim 32, the smallest the card's attention kernels take
TINY = ViTConfig(image_size=32, patch_size=8, hidden_size=64, num_layers=2,
                 num_heads=2, mlp_dim=128, num_classes=4)


def _trainer(tmp_path, device="cpu", config=TINY, batch=4, seed=0,
             compute="float32", task=None):
    cfg = dataclasses.replace(PRESETS["nvit"], global_batch_size=batch,
                              seed=seed, log_dir=str(tmp_path / "log"))
    model = ViT(config, compute, device, param_dtype="float32", seed=0)
    trainer = Trainer(cfg, model=model, device=device, task=task)
    return trainer, trainer.init_state()


def _batches(n, rows=4, side=40, seed=0, dtype=np.uint8, classes=4):
    rng = np.random.default_rng(seed)
    return [{"image": rng.integers(0, 256, (rows, side, side, 3)).astype(dtype),
             "label": rng.integers(0, classes, rows)} for _ in range(n)]


def _state(trainer):
    """Parameters and AdamW state, copied."""
    st = trainer.state
    out = {f"p:{k}": v.detach().clone()
           for k, v in st.model.named_parameters()}
    names = {id(p): k for k, p in st.model.named_parameters()}
    for p, s in st.optimizer.inner.state.items():
        out.update({f"{key}:{names[id(p)]}": v.clone() for key, v in s.items()})
    return out


def _equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("branch", ["cutmix", "mixup"])
def test_mix_as_a_device_vector_equals_the_host_draws_mix(branch, seed):
    rng = np.random.default_rng(seed)
    h, w = 24, 20
    images = torch.from_numpy(rng.random((5, h, w, 3), np.float32))
    labels = torch.nn.functional.one_hot(
        torch.from_numpy(rng.integers(0, 7, 5)), 7).float()
    draw = {"cutmix": branch == "cutmix", "lam": float(rng.beta(1.0, 1.0))}
    if draw["cutmix"]:
        # centres near and past the edges clip the box
        draw.update(cy=float(np.float32(rng.random() * 1.2) * np.float32(h)),
                    cx=float(np.float32(rng.random() * 1.2) * np.float32(w)))
    want = apply_cutmix_or_mixup(images, labels, draw)
    got = apply_mix_params(images, labels,
                           torch.from_numpy(mix_params(draw, h, w)))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("device, processes, engaged", [
    ("cuda", 1, True), ("cuda", 2, False), ("cuda", 4, False),
    ("cpu", 1, False)])
def test_graph_engages_on_one_cuda_process_only(device, processes, engaged):
    assert step_graph.engages(torch.device(device), processes) is engaged


def test_cpu_steps_stay_eager(tmp_path):
    trainer, state = _trainer(tmp_path)
    batches = [trainer.stage(b) for b in _batches(4)]
    for b in batches[:2]:
        trainer.train_step(state, b)
    trainer.train_steps(state, batches[2:])
    assert (trainer.graph_captures, trainer.graph_replays,
            trainer.graph_fallbacks) == (0, 0, 0)
    assert trainer._graphs == {} and trainer._warm == set()


def test_k_step_calls_never_capture_and_each_shape_captures_once(
        tmp_path, monkeypatch):
    trainer, state = _trainer(tmp_path)
    trainer._graphable = True       # as on one CUDA process
    shapes = []

    def capture(state, batch):
        shapes.append(len(batch["image"]))
        return None                 # as a capture that failed: eager

    monkeypatch.setattr(trainer, "_capture", capture)
    four = [trainer.stage(b) for b in _batches(4)]
    two = [trainer.stage(b) for b in _batches(3, rows=2, seed=1)]
    trainer.train_steps(state, four[:2])
    trainer.train_steps(state, four[2:])
    assert shapes == []
    trainer.train_step(state, four[0])      # warms the shape
    assert shapes == []
    trainer.train_step(state, four[1])      # captures
    trainer.train_step(state, four[2])      # never again
    trainer.train_step(state, two[0])
    trainer.train_step(state, two[1])
    trainer.train_step(state, two[2])
    assert shapes == [4, 2]
    assert trainer.graph_captures == trainer.graph_replays == 0


def test_a_capture_that_raises_falls_back_once_and_trains_as_eager(
        tmp_path, monkeypatch, caplog):
    calls = []

    def refuse(body, device, pool, generators=()):
        calls.append(device)
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(step_graph, "capture", refuse)
    monkeypatch.setattr(trainer_mod.torch.cuda, "graph_pool_handle",
                        lambda: "pool")
    host = _batches(4)
    eager, eager_state = _trainer(tmp_path / "eager")
    want = [eager.train_step(eager_state, eager.stage(b)) for b in host]
    trainer, state = _trainer(tmp_path / "graph")
    trainer._graphable = True
    got = [trainer.train_step(state, trainer.stage(b)) for b in host]
    assert len(calls) == 1
    assert (trainer.graph_captures, trainer.graph_replays,
            trainer.graph_fallbacks) == (0, 0, 1)
    assert got == want and _equal(_state(trainer), _state(eager))
    assert all(p.grad is None for p in state.model.parameters())
    assert sum("does not capture as a CUDA graph" in r.getMessage()
               for r in caplog.records) == 1


class _StandInGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_a_capture_takes_its_launches_back_and_each_replay_credits_them(
        monkeypatch):
    monkeypatch.setattr(attention, "launches", 100)
    monkeypatch.setattr(attention, "bwd_launches", 50)
    monkeypatch.setattr(attention, "route_launches",
                        {"wgmma": 150, "mma": 0, "simt": 0})
    monkeypatch.setattr(patch_embed, "launches", 7)
    before = step_graph.launch_counts()
    with step_graph.captured_launches() as launches:
        # what a captured ViT-L step records: K1 and K2 in 24 layers
        attention.launches += 24
        attention.bwd_launches += 24
        attention.route_launches["wgmma"] += 48
    assert launches == {("touhouimageclassification_tpu_torch.ops.attention",
                         "launches"): 24,
                        ("touhouimageclassification_tpu_torch.ops.attention",
                         "bwd_launches"): 24,
                        ("touhouimageclassification_tpu_torch.ops.attention",
                         "route_launches", "wgmma"): 48}
    assert step_graph.launch_counts() == before
    graph = step_graph.StepGraph(
        graph=_StandInGraph(), batch={}, mix=None, generators=(), keys=[],
        scalars=torch.zeros(2), grads=[], outputs=[], launches=launches,
        spans=profiling.GraphSpans())
    for _ in range(3):
        graph.replay()
    assert graph.graph.replays == 3
    assert (attention.launches, attention.bwd_launches) == (100 + 72, 50 + 72)
    assert attention.route_launches == {"wgmma": 150 + 144, "mma": 0,
                                        "simt": 0}
    assert patch_embed.launches == 7


@pytest.mark.parametrize("module", step_graph._COUNTED,
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_every_launch_counter_of_a_kernel_module_is_credited(module):
    """A counter a module adds later is credited by replays only once its
    module lists it in LAUNCH_COUNTERS."""
    counters = {name for name, value in vars(module).items()
                if name.endswith("launches")
                and isinstance(value, (int, dict))}
    assert set(module.LAUNCH_COUNTERS) == counters
    assert {key[1] for key in step_graph.launch_counts()
            if key[0] == module.__name__} == counters


def test_a_capture_that_raises_takes_its_launches_back(monkeypatch):
    monkeypatch.setattr(attention, "launches", 3)
    with pytest.raises(RuntimeError):
        with step_graph.captured_launches() as launches:
            attention.launches += 24
            raise RuntimeError("capture invalidated")
    assert attention.launches == 3 and len(launches) == 1


def test_a_replayed_phase_records_its_device_time_alone():
    profiling.clear()
    profiling.device_span("trainer.forward", 2.5)     # off: nothing
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("trainer.step", id=11):
            profiling.device_span("trainer.forward", 2.5)
    spans = profiling.recorded()
    profiling.clear()
    assert [(s["name"], s["id"], s["parent"], s["host_ms"], s["device_ms"])
            for s in spans] == [("trainer.step", 11, None, spans[0]["host_ms"],
                                 None),
                                ("trainer.forward", 11, 0, 0.0, 2.5)]


class _StandInEvent:
    """A CUDA timing event that records nothing."""

    def __init__(self, **kwargs):
        pass

    def record(self, stream=None):
        pass


def test_the_steps_phases_are_the_graphs_spans_while_it_is_captured(
        tmp_path, monkeypatch):
    """The device half of a step run as the capture runs it, on a stream
    that reports capturing inside ``graph_spans()``: its four phases are
    kept there, in order, each with a pair of events and no counts, and
    nothing reaches the record while the profiler collects."""
    trainer, state = _trainer(tmp_path)
    batch = trainer.stage(_batches(1)[0])
    gens = (torch.Generator().manual_seed(1), torch.Generator().manual_seed(2))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _StandInEvent)
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.graph_spans() as spans:
            trainer._device_step(state.model, batch, gens[0], None, gens[1])
    assert profiling.recorded() == []
    assert [(name, len(events), counts)
            for name, events, counts in spans.entries] == [
        ("trainer.inputs", 2, {}), ("trainer.forward", 2, {}),
        ("trainer.backward", 2, {}), ("trainer.norm", 2, {})]
    assert all(p.grad is not None for p in state.model.parameters())


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


VIT_L = ViTConfig(image_size=224, patch_size=16, hidden_size=1024,
                  num_layers=24, num_heads=16, mlp_dim=4096, num_classes=120,
                  attention_impl="fused", patch_embed_impl="xla")


@pytest.mark.cuda
def test_nvit_batch_8_steps_on_the_graph_equal_eager_steps(tmp_path):
    dev = _cuda()
    host = _batches(4, rows=8, side=256, classes=120)
    runs = {}
    for graphed in (False, True):
        trainer, state = _trainer(tmp_path / str(graphed), dev, VIT_L,
                                  batch=8, compute="bfloat16")
        trainer._graphable = graphed
        k1, k2 = attention.launches, attention.bwd_launches
        metrics = [trainer.train_step(state, trainer.stage(b)) for b in host]
        runs[graphed] = (metrics, _state(trainer),
                         attention.launches - k1, attention.bwd_launches - k2,
                         (trainer.graph_captures, trainer.graph_replays))
        del trainer, state
        torch.cuda.empty_cache()
    (m0, s0, k1_0, k2_0, g0), (m1, s1, k1_1, k2_1, g1) = runs[False], runs[True]
    assert g0 == (0, 0) and g1 == (1, 3)
    assert m1 == m0 and _equal(s1, s0)
    # kernels that ran: 24 a step either way, the capture counted none
    assert k1_0 == k2_0 == k1_1 == k2_1 == 24 * len(host)


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_tiny_steps_on_the_graph_equal_eager_steps(tmp_path, dropout):
    dev = _cuda()
    config = dataclasses.replace(TINY, dropout_rate=dropout)
    host = _batches(5)
    runs = []
    for graphed in (False, True):
        trainer, state = _trainer(tmp_path / str(graphed), dev, config,
                                  compute="bfloat16")
        trainer._graphable = graphed
        runs.append(([trainer.train_step(state, trainer.stage(b))
                      for b in host], _state(trainer)))
    assert trainer.graph_replays == 4
    assert runs[1][0] == runs[0][0] and _equal(runs[1][1], runs[0][1])


@pytest.mark.cuda
def test_a_non_finite_batch_skips_the_update_under_the_graph(tmp_path):
    dev = _cuda()
    host = _batches(4, dtype=np.float32)
    host[2]["image"][1, 3, 4, 0] = np.nan
    trainer, state = _trainer(tmp_path, dev)
    batches = [trainer.stage(b) for b in host]
    trainer.train_step(state, batches[0])
    trainer.train_step(state, batches[1])
    before, count = _state(trainer), state.optimizer.count
    bad = trainer.train_step(state, batches[2])
    assert not np.isfinite(bad["loss"]) and trainer.graph_replays == 2
    assert _equal(_state(trainer), before) and state.step == 3
    assert state.optimizer.count == count
    good = trainer.train_step(state, batches[3])
    assert np.isfinite(good["loss"]) and state.optimizer.count == count + 1
    after = _state(trainer)
    assert not torch.equal(after["p:head.weight"], before["p:head.weight"])
    assert all(torch.isfinite(v).all() for v in after.values())


@pytest.mark.cuda
def test_a_second_batch_shape_captures_once_into_the_shared_pool(tmp_path):
    dev = _cuda()
    four, two = _batches(3), _batches(3, rows=2, seed=1)
    order = [four[0], four[1], two[0], two[1], four[2], two[2]]
    runs = []
    for graphed in (False, True):
        trainer, state = _trainer(tmp_path / str(graphed), dev)
        trainer._graphable = graphed
        runs.append(([trainer.train_step(state, trainer.stage(b))
                      for b in order], _state(trainer)))
    assert (trainer.graph_captures, trainer.graph_replays) == (2, 4)
    pools = {g.graph.pool() for g in trainer._graphs.values()}
    assert len(trainer._graphs) == 2 and pools == {trainer._graph_pool}
    assert runs[1][0] == runs[0][0] and _equal(runs[1][1], runs[0][1])


def _same_steps(runs) -> bool:
    """Both runs fetched the same metrics (NaN equal to NaN) and ended in
    the same state."""
    (m0, s0), (m1, s1) = runs
    return (len(m0) == len(m1)
            and all(a.keys() == b.keys() and np.array_equal(
                list(a.values()), list(b.values()), equal_nan=True)
                for a, b in zip(m0, m1))
            and _equal(s0, s1))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", BN_VARIANTS)
def test_resnet_bn_steps_on_the_graph_equal_eager_steps(tmp_path, monkeypatch,
                                                        variant):
    """The ``resnet152`` preset's step (SGD) on a ResNet-18 with each
    BatchNorm variant: the running statistics move inside the graph."""
    dev = _cuda()
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    cfg = dataclasses.replace(PRESETS["resnet152"], global_batch_size=4,
                              seed=0, log_dir=str(tmp_path / "log"))
    host = _batches(4, side=256)
    runs = []
    for graphed in (False, True):
        model = create_model("resnet18", num_classes=4, device=dev,
                             param_dtype="float32", bn_variant=variant)
        trainer = Trainer(cfg, model=model, device=dev)
        state = trainer.init_state()
        trainer._graphable = graphed
        metrics = [trainer.train_step(state, trainer.stage(b)) for b in host]
        runs.append((metrics, {**_state(trainer), **{
            f"b:{k}": v.clone() for k, v in model.named_buffers()}}))
    assert (trainer.graph_captures, trainer.graph_replays,
            trainer.graph_fallbacks) == (1, 3, 0)
    assert _same_steps(runs)


@pytest.mark.cuda
def test_resmoe_steps_on_the_graph_equal_eager_steps(tmp_path):
    """The ``resmoe`` preset's step (dense routing, the gate's noise from
    the task's generator, SGD accumulating over 4 steps) on small experts."""
    dev = _cuda()
    cfg = dataclasses.replace(PRESETS["resmoe"], global_batch_size=4, seed=0,
                              log_dir=str(tmp_path / "log"))
    host = _batches(9, side=32)
    runs = []
    for graphed in (False, True):
        model = create_model("resmoe", num_classes=4, device=dev,
                             param_dtype="float32", num_experts=3,
                             expert_vit=TINY)
        trainer = Trainer(cfg, model=model, task=MoETask(model.cfg),
                          device=dev)
        state = trainer.init_state()
        trainer._graphable = graphed
        runs.append(([trainer.train_step(state, trainer.stage(b))
                      for b in host], _state(trainer)))
    assert (trainer.graph_captures, trainer.graph_replays,
            trainer.graph_fallbacks) == (1, 8, 0)
    assert state.optimizer.count == 2
    assert _same_steps(runs)


@pytest.mark.cuda
def test_vmoe_steps_on_the_graph_equal_eager_steps(tmp_path):
    """The ``nvit`` step over a small V-MoE (8 experts, 4 held, top-2, two
    routing groups; the router noise from the task's generator): replayed
    steps equal eager ones bit for bit, and a profiled replay records the
    MoE spans of its capture with their device times and counts."""
    dev = _cuda()
    cfg = VMoEConfig(vit=TINY, num_experts=8, group_images=2,
                     num_expert_shards=2)
    host = _batches(5)
    runs = []
    for graphed in (False, True):
        tcfg = dataclasses.replace(PRESETS["nvit"], global_batch_size=4,
                                   log_dir=str(tmp_path / str(graphed)))
        model = VMoE(cfg, "bfloat16", dev, param_dtype="float32", seed=0)
        trainer = Trainer(tcfg, model=model, task=VMoETask(), device=dev)
        state = trainer.init_state()
        trainer._graphable = graphed
        metrics = [trainer.train_step(state, trainer.stage(b))
                   for b in host[:-1]]
        profiling.clear()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            metrics.append(trainer.train_step(state, trainer.stage(host[-1])))
        runs.append((metrics, _state(trainer)))
        spans = profiling.recorded()
        for name in ("moe.route", "moe.dispatch", "moe.experts",
                     "moe.combine"):
            timed = [s for s in spans if s["name"] == name]
            # one MoE layer (layer 1 of 2), forward and backward
            assert len(timed) == 2, (graphed, name)
            assert all(s["device_ms"] > 0 for s in timed)
        counts = [s["counts"] for s in spans if s["name"] == "moe.route"
                  and "assignments" in s["counts"]]
        assert [c["assignments"] for c in counts] == [2 * 2 * 2 * 17]
        assert all(0 < c["kept_held"] <= c["assignments"] for c in counts)
    assert (trainer.graph_captures, trainer.graph_replays,
            trainer.graph_fallbacks) == (1, 4, 0)
    assert _same_steps(runs)


class _SyncingTask(ClassificationTask):
    """A task whose forward waits for the device, as a host-planned
    mixture's may."""

    def forward(self, model, images, batch, train, generator=None):
        if float(images.abs().sum()) < 0:
            images = -images
        return super().forward(model, images, batch, train, generator)


@pytest.mark.cuda
def test_a_capture_that_raises_falls_back_to_eager_once(tmp_path):
    dev = _cuda()
    host = _batches(4)
    runs = []
    for graphed in (False, True):
        trainer, state = _trainer(tmp_path / str(graphed), dev,
                                  task=_SyncingTask())
        trainer._graphable = graphed
        runs.append(([trainer.train_step(state, trainer.stage(b))
                      for b in host], _state(trainer)))
    assert (trainer.graph_captures, trainer.graph_replays,
            trainer.graph_fallbacks) == (0, 0, 1)
    assert runs[1][0] == runs[0][0] and _equal(runs[1][1], runs[0][1])
    # the default generator draws eagerly again, and the card still runs
    # graphs after the failed capture
    draws = []
    for _ in range(2):
        torch.manual_seed(1)
        draws.append(torch.rand(3, device=dev))
    assert torch.equal(*draws)
    other, state = _trainer(tmp_path / "after", dev)
    for b in _batches(3):
        other.train_step(state, other.stage(b))
    assert (other.graph_captures, other.graph_replays) == (1, 2)
