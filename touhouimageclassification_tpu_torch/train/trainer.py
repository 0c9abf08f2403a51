"""The train step and evaluation (counterpart of the step half of the JAX
package's ``train/trainer.py``).

One step runs uint8 batch -> /255 -> on-device augmentation -> one-hot ->
CutMix/MixUp -> forward in ``train()`` mode (bf16 compute over f32
parameters) -> CE -> backward -> leafsum gradient norm -> optimizer update.
As in the JAX package:

- per-step randomness is keyed by ``(cfg.seed, state.step)``, like
  ``fold_in(base_key, step)``: a ``numpy`` generator seeded from the pair
  draws the mixup scalars and seeds the augmentation's ``torch.Generator``
  (and, for models with dropout, the device's default generator for the
  forward);
- the NaN guard: when the loss or the gradient norm is not finite the
  optimizer update is skipped, parameters and optimizer state stay as they
  were, and ``step`` still advances;
- loss, grad_norm and the task's scalars come back to the host in one
  device -> host copy (``_fetch_scalars``). That copy is the step's one sync,
  and the guard branches on the fetched values on the host;
- frozen parameters (``param_filter``, or ``full_finetune=False``) still get
  gradients, which count in ``grad_norm``, but no update and no decay.

Unlike the JAX package the state is updated in place: a :class:`TrainState`
owns the model, whose parameters are the training parameters, and the
optimizer. The epoch loop, checkpoints and the CLIs are not ported yet.
Batches come from :func:`..data.image_loader` (the JAX package's numpy
``HostImageLoader`` for one process) and are uploaded with
:meth:`Trainer.stage`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
from torch import nn

from ..config import TrainConfig
from ..device import resolve_device
from ..models import create_model
from ..ops.augment import build_augment_fn, build_eval_fn
from ..ops.mixup import cutmix_or_mixup
from . import losses
from .optim import Optimizer, global_norm


def _fetch_scalars(metrics: dict[str, torch.Tensor]) -> dict[str, float]:
    """Every 0-d metric in one device -> host copy (stacked on the device);
    other entries are skipped."""
    keys = [k for k, v in metrics.items() if torch.is_tensor(v) and v.dim() == 0]
    if not keys:
        return {}
    vec = torch.stack([metrics[k].float() for k in keys]).cpu()
    return dict(zip(keys, vec.tolist()))


@dataclasses.dataclass
class TrainState:
    """``step`` counts train steps taken, skipped ones included; ``model``
    holds the parameters; ``optimizer`` the update rule and its state."""

    step: int
    model: nn.Module
    optimizer: Optimizer


class ClassificationTask:
    """Default task: the model outputs logits; CE on (possibly soft) targets.
    Tasks own the forward, the loss and the logits extraction for eval."""

    def forward(self, model: nn.Module, images: torch.Tensor, batch: dict,
                train: bool) -> torch.Tensor:
        model.train(train)
        return model(images)

    def loss(self, outputs: torch.Tensor, soft_labels: torch.Tensor):
        return losses.cross_entropy(outputs, soft_labels), {}

    def logits(self, outputs: torch.Tensor) -> torch.Tensor:
        return outputs

    def labels(self, batch: dict) -> torch.Tensor:
        return batch["label"]


class Trainer:
    """Train step and evaluation for ``cfg`` on one device.

    ``model`` defaults to ``create_model(cfg.model_type)`` with f32
    parameters and ``cfg.compute_dtype`` compute. ``init_params`` is a state
    dict loaded into the model by :meth:`init_state` (for example from
    ``utils.convert.from_jax_params`` or ``load_vit_weights``); without it
    the model keeps the weights it has. ``param_filter`` maps a parameter's
    name split on dots (``('layer', '0', 'attn', 'qkv', 'weight')``) to
    whether it trains."""

    def __init__(self, cfg: TrainConfig, model: nn.Module | None = None,
                 task: ClassificationTask | None = None,
                 device: str | torch.device = "cuda",
                 init_params: dict[str, torch.Tensor] | None = None,
                 param_filter: Callable[[tuple[str, ...]], bool] | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if model is None:
            model = create_model(cfg.model_type, compute_dtype=cfg.compute_dtype,
                                 param_dtype="float32", device=self.device)
        self.model = model.to(self.device)
        self.task = task or ClassificationTask()
        size = self.model.cfg.image_size
        self.out_size = (size, size)
        self.num_classes = self.model.cfg.num_classes
        self.augment_fn = build_augment_fn(cfg.augment, self.out_size)
        self.eval_transform = build_eval_fn(cfg.augment, self.out_size)
        self._init_params = init_params
        self.param_filter = param_filter
        self._dropout = (self.model.cfg.dropout_rate > 0
                         or self.model.cfg.attention_dropout_rate > 0)
        self.state: TrainState | None = None

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------

    def _trainable_mask(self) -> dict[str, bool]:
        """Parameter name -> trains. Priority: ``param_filter``, else
        ``full_finetune=False`` trains only the head, else everything
        trains."""
        def trains(parts: tuple[str, ...]) -> bool:
            if self.param_filter is not None:
                return bool(self.param_filter(parts))
            if not self.cfg.full_finetune:
                return any("head" in part for part in parts)
            return True

        return {name: trains(tuple(name.split(".")))
                for name, _ in self.model.named_parameters()}

    def init_state(self, steps_per_epoch: int = 1) -> TrainState:
        if self._init_params is not None:
            self.model.load_state_dict(self._init_params)
        opt_cfg = self.cfg.optimizer
        if opt_cfg.schedule == "warmup_linear" and opt_cfg.total_steps <= 0:
            # wire the decay horizon when the caller didn't: without it the
            # LR would collapse to 0 one step after warmup
            opt_cfg = dataclasses.replace(opt_cfg, total_steps=max(
                steps_per_epoch * self.cfg.max_epochs,
                opt_cfg.warmup_steps + 1))
        mask = self._trainable_mask()
        trainable = [p for name, p in self.model.named_parameters()
                     if mask[name]]
        self.state = TrainState(step=0, model=self.model, optimizer=Optimizer(
            opt_cfg, trainable, steps_per_epoch))
        return self.state

    # ------------------------------------------------------------------
    # steps
    # ------------------------------------------------------------------

    def stage(self, batch: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
        """Upload a loader batch: pinned host copies and non-blocking
        transfers on a CUDA device."""
        staged = {}
        for key, value in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(value))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            staged[key] = t
        return staged

    def _inputs(self, state: TrainState, batch: dict[str, torch.Tensor]):
        """Augmented, normalised, mixed images and soft labels for a step."""
        cfg = self.cfg
        rng = np.random.default_rng([cfg.seed, state.step])
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(rng.integers(2 ** 63)))
        images = self.augment_fn(gen, batch["image"].float() / 255.0)
        labels = nn.functional.one_hot(batch["label"].long(),
                                       self.num_classes).float()
        if cfg.mix.enable_mixup:
            images, labels = cutmix_or_mixup(rng, images, labels,
                                             cfg.mix.mixup_alpha,
                                             cfg.mix.cutmix_alpha)
        return images, labels, int(rng.integers(2 ** 63))

    def train_step(self, state: TrainState,
                   batch: dict[str, torch.Tensor]) -> dict[str, float]:
        """One NaN-guarded step on a staged batch; returns the fetched
        metrics (``loss``, ``grad_norm``, the task's scalars)."""
        images, labels, drop_seed = self._inputs(state, batch)
        model = state.model
        model.zero_grad(set_to_none=True)
        devices = [self.device.index] if self.device.type == "cuda" else []
        with torch.random.fork_rng(devices=devices, enabled=self._dropout):
            if self._dropout:
                torch.manual_seed(drop_seed)
            outputs = self.task.forward(model, images, batch, True)
            loss, aux = self.task.loss(outputs, labels)
            loss.backward()
        grad_norm = global_norm([p.grad for p in model.parameters()
                                 if p.grad is not None])
        metrics = _fetch_scalars({"loss": loss.detach(), "grad_norm": grad_norm,
                                  **aux})
        if np.isfinite(metrics["loss"]) and np.isfinite(metrics["grad_norm"]):
            state.optimizer.update([p.grad for p in state.optimizer.params])
        model.zero_grad(set_to_none=True)
        state.step += 1
        return metrics

    @torch.no_grad()
    def _eval_step(self, state: TrainState, batch: dict[str, torch.Tensor],
                   totals: list[torch.Tensor]) -> None:
        """Adds the batch's masked loss sum, correct and valid counts to
        ``totals`` on the device."""
        images = self.eval_transform(batch["image"].float() / 255.0)
        outputs = self.task.forward(state.model, images, batch, False)
        logits = self.task.logits(outputs)
        labels = self.task.labels(batch).long()
        mask = batch["mask"].bool()
        logp = nn.functional.log_softmax(logits.float(), dim=-1)
        per_sample = -logp.gather(-1, labels[:, None])[:, 0]
        correct, total = losses.accuracy(logits, labels, mask)
        totals[0] += (per_sample * mask).sum()
        totals[1] += correct
        totals[2] += total

    def evaluate(self, loader, state: TrainState | None = None,
                 limit: int = 0) -> dict[str, float]:
        state = state if state is not None else self.state
        totals = [torch.zeros((), dtype=dt, device=self.device)
                  for dt in (torch.float32, torch.int64, torch.int64)]
        for i, batch in enumerate(loader):
            if limit and i >= limit:
                break
            self._eval_step(state, self.stage(batch), totals)
        loss_sum, correct, total = torch.stack(
            [t.double() for t in totals]).cpu().tolist()
        if total == 0:
            raise ValueError(
                "evaluate: no valid samples (empty val split or every "
                "image masked); check train_split/data_dir")
        return {"val_loss": loss_sum / total, "val_acc": correct / total}

    def test(self, test_loader, state: TrainState | None = None) -> dict[str, Any]:
        out = self.evaluate(test_loader, state)
        return {"test_loss": out["val_loss"], "test_acc": out["val_acc"]}
