"""Optimizers and LR schedules from :class:`OptimizerConfig` (counterpart of
the JAX package's ``train/optim.py``).

:class:`Optimizer` reproduces the optax chain the JAX package builds:
``optax.MultiSteps(chain(clip_by_global_norm, adamw | sgd))`` with the
schedule counting inner updates.

- AdamW is ``torch.optim.AdamW`` with optax's defaults (b1 .9, b2 .999,
  eps 1e-8) and decoupled decay on every parameter it is given; SGD is
  ``torch.optim.SGD`` with momentum (optax's trace) and no weight decay.
- ``clip_by_global_norm`` when ``max_grad_norm > 0``, as optax computes it.
- Gradient accumulation with ``optax.MultiSteps`` semantics: the running mean
  over k micro-steps; the inner update, and with it the schedule's count,
  advances only on every k-th step.

The update is plain PyTorch: it was no Pallas kernel in the JAX package
either. The NaN guard lives in the trainer.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..config import OptimizerConfig


def build_schedule(cfg: OptimizerConfig,
                   steps_per_epoch: int = 1) -> Callable[[int], float]:
    """LR as a function of the count of inner updates made before this one,
    as optax's schedules take it."""
    lr = cfg.learning_rate
    if cfg.schedule == "constant":
        return lambda count: lr
    if cfg.schedule == "warmup_linear":
        warmup = cfg.warmup_steps
        total = max(cfg.total_steps, warmup + 1)

        def warmup_linear(count: int) -> float:
            # optax.join_schedules of two linear_schedules, each clipped
            # to its span
            if count < warmup:
                return lr * count / warmup
            return lr * (1.0 - min(count - warmup, total - warmup)
                         / (total - warmup))
        return warmup_linear
    if cfg.schedule == "step":
        def step_lr(count: int) -> float:
            epoch = count // max(steps_per_epoch, 1)
            return lr * cfg.step_lr_gamma ** (epoch // cfg.step_lr_epoch_size)
        return step_lr
    raise ValueError(f"Unknown schedule: {cfg.schedule}")


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """L2 norm of all tensors together, as the JAX package's leafsum
    ``fast_global_norm``: per-tensor f32 sums of squares, added in order.
    Non-finite values propagate, so its finiteness doubles as the NaN/Inf
    gradient check. A 0-d tensor on the tensors' device."""
    total = torch.zeros((), dtype=torch.float32, device=tensors[0].device)
    for t in tensors:
        total = total + t.float().square().sum()
    return total.sqrt()


def clip_by_global_norm(grads: list[torch.Tensor],
                        max_norm: float) -> list[torch.Tensor]:
    """optax.clip_by_global_norm: unchanged below ``max_norm``, else each
    gradient is ``g / norm * max_norm``. Decided on the device, no sync."""
    norm = global_norm(grads)
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm.to(g.dtype) * max_norm)
            for g in grads]


def build_optimizer(cfg: OptimizerConfig,
                    params: Sequence[torch.Tensor]) -> torch.optim.Optimizer:
    """The inner update rule: ``optax.adamw`` as ``torch.optim.AdamW``
    (decoupled decay on every parameter given), ``optax.sgd`` as
    ``torch.optim.SGD`` with momentum and no weight decay. The LR is set per
    update by :class:`Optimizer`."""
    if cfg.name == "adamw":
        return torch.optim.AdamW(params, lr=cfg.learning_rate,
                                 betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=cfg.weight_decay)
    if cfg.name == "sgd":
        return torch.optim.SGD(params, lr=cfg.learning_rate,
                               momentum=cfg.momentum)
    raise ValueError(f"Unknown optimizer: {cfg.name}")


class Optimizer:
    """The JAX package's optimizer over ``params`` (the trainable ones):
    ``update(grads)`` takes their gradients of one micro-step, in order, and
    keeps them while it accumulates."""

    def __init__(self, cfg: OptimizerConfig, params: Sequence[torch.Tensor],
                 steps_per_epoch: int = 1):
        self.cfg = cfg
        self.params = list(params)
        self.schedule = build_schedule(cfg, steps_per_epoch)
        self.inner = build_optimizer(cfg, self.params)
        self.k = max(1, cfg.grad_accum_steps)
        self.count = 0          # inner updates made (the schedule's count)
        self.mini_step = 0      # micro-steps accumulated since the last one
        self.acc: list[torch.Tensor] | None = None

    @property
    def lr(self) -> float:
        """The LR the next inner update uses."""
        return self.schedule(self.count)

    def update(self, grads: Sequence[torch.Tensor]) -> bool:
        """One micro-step; returns whether the parameters changed."""
        grads = list(grads)
        if self.k > 1:
            n = self.mini_step
            self.acc = (grads if self.acc is None else
                        [(g + n * a) / (n + 1) for g, a in zip(grads, self.acc)])
            self.mini_step += 1
            if self.mini_step < self.k:
                return False
            grads, self.acc, self.mini_step = self.acc, None, 0
        if self.cfg.max_grad_norm > 0:
            grads = clip_by_global_norm(grads, self.cfg.max_grad_norm)
        for group in self.inner.param_groups:
            group["lr"] = self.lr
        for p, g in zip(self.params, grads):
            p.grad = g
        self.inner.step()
        self.count += 1
        return True
