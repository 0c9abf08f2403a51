"""The port's AdamW (``ops/adamw.py``, kernel ``csrc/adamw.cu``) against
``torch.optim.AdamW``.

On the CPU, where the step is torch's own: five steps with decay and a
parameter without a gradient equal torch's bit for bit, and so do the
updates of the port's ``Optimizer``, which hands the gradients over on
``.grad``; the state dict
round-trips, and a state dict of ``torch.optim.AdamW`` (checkpoints written
before the kernel) loads and continues as torch continues; the optimizer's
``mark`` / ``restore`` / ``hold`` / ``keep_if`` leave what they left with
``torch.optim.AdamW`` inside; the ``trainer.update`` span counts the
elements the update wrote and no kernel launch.

On the card (marked ``cuda``; the module imports nothing of JAX, so
``python -m pytest --noconftest tests/test_torch_adamw.py -m cuda`` runs
them there): what the kernel refuses (a tensor that is not f32, not
contiguous, a sparse gradient) raises; over 10 steps on ViT-L's parameter
list, one V-MoE expert tensor (16 x 1024 x 4096) and odd sizes (1, 3,
120 x 1024, a view at an odd offset) p, m and v stay within 2 ulp a step of
torch's foreach route; one launch an update, the table uploaded once while
the addresses hold, set by hand or by the port's ``Optimizer``; a
``train_steps`` call of 4 ends bit-equal to 4 ``train_step`` calls.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from touhouimageclassification_tpu_torch.config import (PRESETS,
                                                        OptimizerConfig,
                                                        ViTConfig)
from touhouimageclassification_tpu_torch.models.vit import ViT
from touhouimageclassification_tpu_torch.ops import adamw
from touhouimageclassification_tpu_torch.train.optim import Optimizer
from touhouimageclassification_tpu_torch.train.trainer import Trainer
from touhouimageclassification_tpu_torch.utils import profiling

torch.set_num_threads(1)

HYPER = dict(lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.05)
SHAPES = [(7, 5), (3,), (4, 2, 3), (1,), (6,)]


def _params(device="cpu", shapes=SHAPES, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=gen).to(device) for s in shapes]


def _grads(params, step, skip=()):
    """Seeded gradients of ``params`` for ``step``; None at ``skip``."""
    gen = torch.Generator().manual_seed(1000 + step)
    return [None if i in skip else torch.randn(p.shape, generator=gen).to(
        p.device) for i, p in enumerate(params)]


def _run(opt, params, steps, first=0, skip=(), lrs=None):
    for t in range(first, first + steps):
        for p, g in zip(params, _grads(params, t, skip)):
            p.grad = g
        if lrs is not None:
            for group in opt.param_groups:
                group["lr"] = lrs[t]
        opt.step()


def _state(opt, params):
    """Parameters and per-parameter state, by position."""
    out = {f"p{i}": p.detach().clone() for i, p in enumerate(params)}
    for i, p in enumerate(params):
        out.update({f"{k}{i}": v.clone() for k, v in opt.state[p].items()})
    return out


def _assert_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

def test_port_adamw_is_torch_adamw_on_the_cpu():
    ours, theirs = _params(), _params()
    opt = adamw.AdamW(ours, **HYPER)
    ref = torch.optim.AdamW(theirs, **HYPER)
    assert isinstance(opt, torch.optim.AdamW)
    launches = adamw.launches
    lrs = [1e-3, 2e-3, 5e-4, 1e-3, 3e-3]
    _run(opt, ours, 5, skip=(1,), lrs=lrs)
    _run(ref, theirs, 5, skip=(1,), lrs=lrs)
    _assert_equal(_state(opt, ours), _state(ref, theirs))
    # the parameter without a gradient has no state and kept its value
    assert opt.state[ours[1]] == {} and torch.equal(ours[1], _params()[1])
    assert opt.state[ours[0]]["step"].item() == 5.0
    assert opt.state[ours[0]]["step"].device.type == "cpu"
    assert opt.state[ours[0]]["step"].dtype == torch.float32
    assert adamw.launches == launches


def test_state_dict_round_trips_and_continues():
    ours = _params()
    opt = adamw.AdamW(ours, **HYPER)
    _run(opt, ours, 3)
    again = [p.clone() for p in ours]
    loaded = adamw.AdamW(again, **HYPER)
    # a copy, as a checkpoint holds it (a state dict shares the step tensors)
    loaded.load_state_dict(copy.deepcopy(opt.state_dict()))
    _assert_equal(_state(loaded, again), _state(opt, ours))
    _run(opt, ours, 2, first=3)
    _run(loaded, again, 2, first=3)
    _assert_equal(_state(loaded, again), _state(opt, ours))


def test_gradients_handed_in_are_read_as_grad_attributes():
    """The port's ``Optimizer`` hands each update's gradients over on
    ``.grad``; a parameter given None is skipped, as torch skips it."""
    ours = _optimizer(_params())
    theirs = _optimizer(_params(), torch.optim.AdamW)
    for t in range(3):
        for opt in (ours, theirs):
            opt.update(_grads(opt.params, t, skip=(3,)))
    _assert_equal(_state(ours.inner, ours.params),
                  _state(theirs.inner, theirs.params))
    assert ours.inner.state[ours.params[3]] == {}


def test_a_torch_adamw_state_dict_loads_and_continues():
    """A checkpoint written before the kernel holds ``torch.optim.AdamW``'s
    state dict: the port's optimizer takes it and continues as torch does."""
    theirs = _params()
    ref = torch.optim.AdamW(theirs, **HYPER)
    _run(ref, theirs, 3, skip=(2,))
    saved = copy.deepcopy(ref.state_dict())
    ours = [p.clone() for p in theirs]
    opt = adamw.AdamW(ours, **HYPER)
    opt.load_state_dict(saved)
    assert opt.state_dict()["param_groups"] == saved["param_groups"]
    _run(ref, theirs, 3, first=3)
    _run(opt, ours, 3, first=3)
    _assert_equal(_state(opt, ours), _state(ref, theirs))


def _optimizer(params, inner=None, **over):
    cfg = OptimizerConfig(name="adamw", learning_rate=1e-2, weight_decay=0.05,
                          **over)
    opt = Optimizer(cfg, params)
    if inner is not None:
        opt.inner = inner(params, lr=1e-2, betas=(0.9, 0.999), eps=1e-8,
                          weight_decay=0.05)
    return opt


def _script(opt):
    """A k-step call's moves: updates kept and dropped on the device flag,
    and the host counters taken back to a mark."""
    yes, no = torch.tensor(True), torch.tensor(False)
    states = []
    for t, (ok, back) in enumerate([(yes, False), (no, False), (yes, True),
                                    (yes, False), (no, True), (yes, False)]):
        mark = opt.mark()
        held = opt.hold()
        opt.update(_grads(opt.params, t))
        opt.keep_if(ok, held)
        if back:
            opt.restore(mark)
        states.append((_state(opt.inner, opt.params),
                       (opt.count, opt.mini_step)))
    return states


@pytest.mark.parametrize("over", [{}, {"max_grad_norm": 0.5},
                                  {"grad_accum_steps": 2}])
def test_guard_moves_leave_what_they_left_with_torch_adamw(over):
    ours = _optimizer(_params(), **over)
    assert isinstance(ours.inner, adamw.AdamW)
    theirs = _optimizer(_params(), torch.optim.AdamW, **over)
    assert type(theirs.inner) is torch.optim.AdamW
    for (a, ca), (b, cb) in zip(_script(ours), _script(theirs)):
        assert ca == cb
        _assert_equal(a, b)


def test_update_span_counts_elements_and_no_launch_on_the_cpu(tmp_path):
    cfg = dataclasses.replace(PRESETS["nvit"], global_batch_size=2,
                              log_dir=str(tmp_path / "log"))
    config = ViTConfig(image_size=16, patch_size=8, hidden_size=16,
                       num_layers=1, num_heads=2, mlp_dim=32, num_classes=4)
    trainer = Trainer(cfg, model=ViT(config, "float32", "cpu",
                                     param_dtype="float32"), device="cpu")
    state = trainer.init_state()
    rng = np.random.default_rng(0)
    batch = trainer.stage({"image": rng.integers(0, 256, (2, 20, 20, 3)
                                                 ).astype(np.uint8),
                           "label": np.arange(2) % 4})
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        trainer.train_step(state, batch)
    updates = [s for s in profiling.recorded() if s["name"] == "trainer.update"]
    trainable = sum(p.numel() for p in state.optimizer.params)
    assert [s["counts"] for s in updates] == [{"elements": trainable,
                                               "launches": 0}]


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _one_step(params, grads):
    opt = adamw.AdamW(params, **HYPER)
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()


@pytest.mark.cuda
def test_a_tensor_the_kernel_does_not_take_raises():
    dev = _cuda()
    half = torch.zeros(8, device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="float32"):
        _one_step([half], [torch.ones_like(half)])
    strided = torch.zeros(8, 6, device=dev).t()
    with pytest.raises(ValueError, match="contiguous"):
        _one_step([strided], [torch.ones_like(strided)])
    dense = torch.zeros(8, 6, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        _one_step([dense], [torch.ones(6, 8, device=dev).t()])
    sparse = torch.sparse_coo_tensor(torch.tensor([[0, 3]]),
                                     torch.ones(2), (8,)).to(dev)
    with pytest.raises(ValueError, match="sparse"):
        _one_step([torch.zeros(8, device=dev)], [sparse])


def _vit_l_shapes():
    config = ViTConfig(image_size=224, patch_size=16, hidden_size=1024,
                       num_layers=24, num_heads=16, mlp_dim=4096,
                       num_classes=120)
    return [tuple(p.shape) for p in ViT(config, "float32", "cuda",
                                        param_dtype="float32").parameters()]


def _case(name, dev):
    """(ours, theirs): the same values, ours as the case lays them out."""
    if name == "vit_l":
        shapes = _vit_l_shapes()
    elif name == "expert":
        shapes = [(16, 1024, 4096)]
    else:
        shapes = [(1,), (3,), (120, 1024)]
    theirs = [torch.randn(s, device=dev) for s in shapes]
    ours = [t.clone() for t in theirs]
    if name == "odd":
        # a parameter that starts 4 bytes past a 16-byte boundary
        base = torch.empty(1 + 1000, device=dev)
        view = base[1:]
        view.copy_(torch.randn(1000, device=dev))
        ours.append(view)
        theirs.append(view.clone())
    return ours, theirs


def _ulp(x):
    x = x.abs()
    return torch.nextafter(x, torch.full_like(x, float("inf"))) - x


def _gap_ulps(got, want, *scales):
    """Largest |got - want| in ulps of the largest operand's magnitude."""
    scale = torch.stack([s.abs() for s in scales]).amax(0)
    return ((got - want).abs() / _ulp(scale)).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["vit_l", "expert", "odd"])
def test_kernel_within_2_ulp_a_step_of_torch_adamw(case):
    dev = _cuda()
    torch.manual_seed(0)
    ours, theirs = _case(case, dev)
    opt = adamw.AdamW(ours, **HYPER)
    ref = torch.optim.AdamW(theirs, foreach=True, **HYPER)
    launches, worst = adamw.launches, 0.0
    for t in range(1, 11):
        lr = 1e-3 * (1 + t % 3)
        for group in opt.param_groups + ref.param_groups:
            group["lr"] = lr
        before = [(p.clone(), ref.state[p].get("exp_avg"),
                   ref.state[p].get("exp_avg_sq")) for p in theirs]
        before = [(p, m.clone() if m is not None else torch.zeros_like(p),
                   v.clone() if v is not None else torch.zeros_like(p))
                  for p, m, v in before]
        for a, b in zip(ours, theirs):
            b.grad = torch.randn_like(b)
            a.grad = b.grad.clone()
        opt.step()
        ref.step()
        for a, b, (p0, m0, v0) in zip(ours, theirs, before):
            sa, sb, g = opt.state[a], ref.state[b], b.grad
            gaps = (_gap_ulps(a, b, b, p0),
                    _gap_ulps(sa["exp_avg"], sb["exp_avg"], sb["exp_avg"],
                              m0, g),
                    _gap_ulps(sa["exp_avg_sq"], sb["exp_avg_sq"],
                              sb["exp_avg_sq"], v0, g * g))
            worst = max(worst, *gaps)
            assert max(gaps) <= 2 * t, (case, t, gaps)
            assert sa["step"].item() == sb["step"].item() == t
    assert adamw.launches - launches == 10
    print(f"{case}: largest gap {worst} ulp over 10 steps")


@pytest.mark.cuda
def test_one_launch_an_update_and_the_table_kept_while_addresses_hold():
    dev = _cuda()
    params = [torch.randn(s, device=dev) for s in [(1024, 1024), (3,), (5, 7)]]
    grads = [torch.zeros_like(p) for p in params]
    opt = adamw.AdamW(params, **HYPER)
    launches = adamw.launches
    for t in range(4):
        for p, g in zip(params, grads):
            g.copy_(torch.randn_like(g))    # the graph's way: same tensors
            p.grad = g
        opt.step()
        assert adamw.launches - launches == t + 1
    assert opt.table_uploads == 1
    params[1].grad = torch.randn(3, device=dev)     # another address
    opt.step()
    assert opt.table_uploads == 2 and adamw.launches - launches == 5
    # the port's Optimizer, handed the same gradient tensors each update,
    # keeps its table too
    port = _optimizer(params)
    port.update(grads)
    port.update(grads)
    assert port.inner.table_uploads == 1 and adamw.launches - launches == 7


@pytest.mark.cuda
def test_k_step_call_ends_bit_equal_to_single_steps(tmp_path):
    dev = _cuda()
    config = ViTConfig(image_size=32, patch_size=8, hidden_size=64,
                       num_layers=2, num_heads=2, mlp_dim=128, num_classes=4)
    rng = np.random.default_rng(0)
    host = [{"image": rng.integers(0, 256, (4, 40, 40, 3)).astype(np.uint8),
             "label": rng.integers(0, 4, 4)} for _ in range(4)]
    runs = []
    for k in (1, 4):
        cfg = dataclasses.replace(PRESETS["nvit"], global_batch_size=4,
                                  log_dir=str(tmp_path / str(k)))
        model = ViT(config, "bfloat16", dev, param_dtype="float32", seed=0)
        trainer = Trainer(cfg, model=model, device=dev)
        state = trainer.init_state()
        batches = [trainer.stage(b) for b in host]
        launches = adamw.launches
        if k == 1:
            for b in batches:
                trainer.train_step(state, b)
        else:
            trainer.train_steps(state, batches)
        assert adamw.launches - launches == 4
        runs.append(_state(state.optimizer.inner, state.optimizer.params))
    _assert_equal(runs[0], runs[1])
