"""The train step and evaluation (counterpart of the step half of the JAX
package's ``train/trainer.py``).

One step runs uint8 batch -> /255 -> on-device augmentation -> one-hot ->
CutMix/MixUp -> forward in ``train()`` mode (bf16 compute over f32
parameters) -> CE -> backward -> leafsum gradient norm -> optimizer update.
As in the JAX package:

- per-step randomness is keyed by ``(cfg.seed, state.step)``, like
  ``fold_in(base_key, step)``: a ``numpy`` generator seeded from the pair
  draws the mixup scalars and seeds the augmentation's ``torch.Generator``,
  the task's forward generator (ResMoE's gate noise, JAX's ``k_gate``) and,
  for models with dropout, the device's default generator for the forward;
- the NaN guard (``cfg.nan_guard``): when the loss or the gradient norm is
  not finite the optimizer update is skipped, parameters, optimizer state
  and the model's floating buffers (a ResNet's BatchNorm running
  statistics, which the forward updates in place) stay as they were, and
  ``step`` still advances. The buffers are copied on the device before the
  forward and put back only for a skipped step. With ``nan_guard=False``
  the update, the optimizer state and the buffers are committed whatever
  their values, as in JAX;
- loss, grad_norm and the task's scalars come back to the host in one
  device -> host copy (``_fetch_scalars``). That copy is the step's one sync,
  and the guard branches on the fetched values on the host (in a k-step
  call, on the device: :meth:`Trainer.train_steps`);
- frozen parameters (``param_filter``, or ``full_finetune=False``) still get
  gradients, which count in ``grad_norm``, but no update and no decay.

Unlike the JAX package the state is updated in place: a :class:`TrainState`
owns the model, whose parameters are the training parameters, and the
optimizer. Batches come from :func:`..data.image_loader` (the numpy
``HostImageLoader`` for one process) and are uploaded with
:meth:`Trainer.stage`.

:meth:`Trainer.fit` is the JAX package's epoch loop: per-epoch records in
``<log_dir>/<train_id>/metrics.jsonl``, safetensors checkpoints with the
same retention (``train/checkpoint.py``), both early-stop rules with their
state saved in each checkpoint, the profiled window, and exact resume: from
an explicit path, or automatically from the newer of the last full save and
the mid-epoch ``<run>_partial`` save that SIGTERM leaves, fast-forwarding
the loader. With ``cfg.steps_per_call = k > 1`` it trains k loader batches
a call (:meth:`Trainer.train_steps`: one host sync a call, the metrics the
call's means, the NaN guard decided on the device), agrees on a SIGTERM
once a call, counts ``limit_train_batches`` and the resume offset in loader
batches, multiples of k, and drops an epoch's last batches that fill no
call, with JAX's warning.

Several processes (``parallel/``, one rank a device) train on a (data,
expert) mesh, by default every rank on the data axis and
``cfg.mesh.num_expert_shards`` on the expert axis. A step on P data ranks
computes what one process computes on the global batch: each rank loads
its slice of it (``_apply_input_view``), the augmentation, the mixup, the
losses, the BatchNorm moments and the capacity plans are the global
batch's (``parallel/collectives.py``), and after the backward the
gradients are averaged over the data group in flat buckets, so the
gradient norm, the NaN guard's verdict and the fetched loss are the same on
every rank. The mixtures' ``experts`` / ``sons`` are split over the expert
axis (``parallel/sharding.py``): a rank holds, runs and updates only its
own members and the replicated rest; the others are on the meta device. Rank 0 alone writes ``metrics.jsonl``;
every step the ranks agree on a SIGTERM any of them received
(``_agree_preempted``), so all stop at the same step; each checkpoint is
written by the ranks that hold its parts (``train/checkpoint.py``).
Dropout masks are drawn per rank, not for the global batch.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import signal
import threading
import time
from typing import Any, Callable

import numpy as np
import torch
from torch import nn

from ..config import TrainConfig, get_image_size
from ..device import resolve_device
from ..models import create_model, member_vit_config
from ..ops.augment import build_augment_fn, build_eval_fn
from ..ops.mixup import cutmix_or_mixup
from ..parallel import collectives, sharding
from ..parallel.dist import world
from ..parallel.mesh import create_mesh, process_input_view
from ..utils.logging import get_logger
from ..utils.profiling import span, trace
from . import losses
from .checkpoint import CheckpointManager
from .optim import Optimizer, global_norm


def _fetch_scalars(metrics: dict[str, torch.Tensor]) -> dict[str, float]:
    """Every 0-d metric in one device -> host copy (stacked on the device);
    other entries are skipped."""
    keys = [k for k, v in metrics.items() if torch.is_tensor(v) and v.dim() == 0]
    if not keys:
        return {}
    vec = torch.stack([metrics[k].float() for k in keys]).cpu()
    return dict(zip(keys, vec.tolist()))


def _groups(batches, k: int):
    """Runs of ``k`` consecutive batches as lists; a shorter tail is
    dropped."""
    group = []
    for batch in batches:
        group.append(batch)
        if len(group) == k:
            yield group
            group = []


def window_early_exit(timeline: list, patience: int, mode: str = "min") -> bool:
    """The hand-rolled loops' early-exit rule (``finetune.py:79-91``): stop
    when nothing in the last ``patience`` epochs improved on the value
    recorded just before that window. Ties count as "not improved"."""
    if not patience or len(timeline) < patience:
        return False
    sign = 1.0 if mode == "max" else -1.0
    window = timeline[-(patience + 1):]
    return all(sign * v <= sign * window[0] for v in window[1:])


@dataclasses.dataclass
class TrainState:
    """``step`` counts train steps taken, skipped ones included; ``model``
    holds the parameters; ``optimizer`` the update rule and its state."""

    step: int
    model: nn.Module
    optimizer: Optimizer


class ClassificationTask:
    """Default task: the model outputs logits; CE on (possibly soft) targets.
    Tasks own the forward, the loss and the logits extraction for eval.
    ``generator`` (a device ``torch.Generator`` seeded per train step) is
    for a task whose model draws noise in training."""

    def forward(self, model: nn.Module, images: torch.Tensor, batch: dict,
                train: bool, generator: torch.Generator | None = None):
        model.train(train)
        return model(images)

    def loss(self, outputs: torch.Tensor, soft_labels: torch.Tensor):
        return losses.cross_entropy(outputs, soft_labels), {}

    def logits(self, outputs: torch.Tensor) -> torch.Tensor:
        return outputs

    def labels(self, batch: dict) -> torch.Tensor:
        return batch["label"]


class Trainer:
    """Train step, evaluation and the epoch loop for ``cfg`` on one device.

    ``model`` defaults to ``create_model(cfg.model_type)`` with f32
    parameters, ``cfg.compute_dtype`` compute and the initialisation drawn
    from ``cfg.seed``; the image size is its config's ``image_size`` (a
    mixture's: its members'; else ``get_image_size(cfg.model_type)``), and
    dropout is keyed per step only where that config has a nonzero dropout
    rate. ``init_params`` is a state
    dict loaded into the model by :meth:`init_state` (for example from
    ``utils.convert.from_jax_params`` or ``load_vit_weights``); without it
    the model keeps the weights it has. ``param_filter`` maps a parameter's
    name split on dots (``('layer', '0', 'attn', 'qkv', 'weight')``) to
    whether it trains. The mesh is :func:`~..parallel.mesh.create_mesh`
    over every rank with ``cfg.mesh.num_expert_shards`` on the expert axis
    (one rank without a process group)."""

    def __init__(self, cfg: TrainConfig, model: nn.Module | None = None,
                 task: ClassificationTask | None = None,
                 device: str | torch.device = "cuda",
                 init_params: dict[str, torch.Tensor] | None = None,
                 param_filter: Callable[[tuple[str, ...]], bool] | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = create_mesh(num_expert=cfg.mesh.num_expert_shards)
        if model is None:
            model = create_model(cfg.model_type, compute_dtype=cfg.compute_dtype,
                                 param_dtype="float32", device=self.device,
                                 seed=cfg.seed)
        # a model that an earlier Trainer of this rank released members of
        # is on its device already (a meta tensor cannot be moved)
        if not any(p.is_meta for p in model.parameters()):
            model = model.to(self.device)
        self.model = model
        self.task = task or ClassificationTask()
        model_cfg = self.model.cfg
        # ResMoE and TreeViT carry their members' ViT config inside theirs
        inner = member_vit_config(model_cfg) or model_cfg
        size = getattr(inner, "image_size", None)
        self.out_size = ((size, size) if isinstance(size, int)
                         else get_image_size(cfg.model_type))
        self.num_classes = model_cfg.num_classes
        self.augment_fn = build_augment_fn(cfg.augment, self.out_size)
        self.eval_transform = build_eval_fn(cfg.augment, self.out_size)
        self._init_params = init_params
        self.param_filter = param_filter
        self._dropout = any(getattr(inner, name, 0) > 0 for name in (
            "dropout_rate", "attention_dropout_rate"))
        self.state: TrainState | None = None
        # device -> host copies made by the train steps: one a train_step,
        # one a train_steps call
        self.host_syncs = 0
        self._metrics_path = os.path.join(cfg.log_dir, cfg.train_id,
                                          "metrics.jsonl")
        self._preempted = False
        # the slice of each global batch this rank loads, from the mesh (a
        # pure expert-parallel mesh replicates the batch: every rank loads
        # all of it)
        self._input_view = process_input_view(self.mesh)
        self._multi = world()[1] > 1
        # one process writes the metrics; checkpoints are written by the
        # ranks that hold their parts
        self._is_main = world()[0] == 0
        # parameter name -> the expert rank that holds it (None: every rank)
        sizes = sharding.stack_sizes(self.model)
        self._owner = {name: sharding.owner(name, sizes, self.mesh.num_expert)
                       for name, _ in self.model.named_parameters()}
        self._released = sharding.release_unowned(
            self.model, self.mesh.num_expert, self.mesh.expert_index)

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
            # strict but for the members this rank released
            keys = self.model.load_state_dict({
                k: v for k, v in self._init_params.items()
                if k not in self._released}, strict=False)
            missing = set(keys.missing_keys) - self._released
            if missing or keys.unexpected_keys:
                raise KeyError(f"init_params: missing {sorted(missing)[:5]}, "
                               f"unexpected {keys.unexpected_keys[:5]}")
        opt_cfg = self.cfg.optimizer
        if opt_cfg.schedule == "warmup_linear" and opt_cfg.total_steps <= 0:
            # wire the decay horizon when the caller didn't: without it the
            # LR would collapse to 0 one step after warmup
            opt_cfg = dataclasses.replace(opt_cfg, total_steps=max(
                steps_per_epoch * self.cfg.max_epochs,
                opt_cfg.warmup_steps + 1))
        mask = self._trainable_mask()
        trainable = [p for name, p in self.model.named_parameters()
                     if mask[name] and self._holds(name)]
        optimizer = Optimizer(opt_cfg, trainable, steps_per_epoch)
        if self.mesh.expert_group is not None:
            names = {id(p): n for n, p in self.model.named_parameters()}
            optimizer.norm_split = ([self._owner[names[id(p)]] is not None
                                     for p in trainable],
                                    self.mesh.expert_group)
        self.state = TrainState(step=0, model=self.model, optimizer=optimizer)
        return self.state

    def _holds(self, name: str) -> bool:
        """Whether this rank holds (runs and updates) parameter ``name``."""
        owner = self._owner[name]
        return owner is None or owner == self.mesh.expert_index

    # ------------------------------------------------------------------
    # steps
    # ------------------------------------------------------------------

    def stage(self, batch: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
        """Upload a loader batch: pinned host copies and non-blocking
        transfers on a CUDA device."""
        staged = {}
        with span("trainer.stage") as phase:
            for key, value in batch.items():
                t = torch.from_numpy(np.ascontiguousarray(value))
                if self.device.type == "cuda":
                    t = t.pin_memory().to(self.device, non_blocking=True)
                staged[key] = t
            phase.set(rows=len(staged["image"]),
                      bytes=sum(t.nbytes for t in staged.values()))
        return staged

    def _inputs(self, state: TrainState, batch: dict[str, torch.Tensor]):
        """Augmented, normalised, mixed images and soft labels for a step,
        and the seeds of its dropout and of the task's forward generator."""
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
        return (images, labels, int(rng.integers(2 ** 63)),
                int(rng.integers(2 ** 63)))

    def _buffers(self, model: nn.Module):
        """The model's floating buffers and, under the NaN guard, one flat
        device copy of them to put back on a skipped step."""
        buffers = [b for b in model.buffers() if b.is_floating_point()]
        saved = (torch.cat([b.reshape(-1) for b in buffers])
                 if buffers and self.cfg.nan_guard else None)
        return buffers, saved

    def _loss_and_grads(self, state: TrainState,
                        batch: dict[str, torch.Tensor]):
        """The forward and backward of a step: its loss, the task's scalars
        and the gradient norm, the gradients left in ``.grad`` (averaged
        over the data group)."""
        model = state.model
        devices = [self.device.index] if self.device.type == "cuda" else []
        dev = self.device
        with collectives.use_mesh(self.mesh):
            with span("trainer.inputs", device=dev):
                images, labels, drop_seed, task_seed = self._inputs(state,
                                                                    batch)
            task_gen = torch.Generator(device=dev).manual_seed(task_seed)
            with torch.random.fork_rng(devices=devices,
                                       enabled=self._dropout):
                if self._dropout:
                    torch.manual_seed(drop_seed)
                with span("trainer.forward", device=dev):
                    outputs = self.task.forward(model, images, batch, True,
                                                task_gen)
                    loss, aux = self.task.loss(outputs, labels)
                with span("trainer.backward", device=dev):
                    loss.backward()
        with span("trainer.norm", device=dev):
            grads, sharded = self._reduced_gradients(model)
            grad_norm = global_norm(grads, sharded, self.mesh.expert_group)
        return loss.detach(), aux, grad_norm

    def train_step(self, state: TrainState,
                   batch: dict[str, torch.Tensor]) -> dict[str, float]:
        """One step on a staged batch (this rank's rows of the global
        batch), NaN-guarded unless ``cfg.nan_guard`` is False; returns the
        fetched metrics (``loss``, ``grad_norm``, the task's scalars)."""
        model = state.model
        with span("trainer.step", id=state.step, rows=len(batch["image"])):
            model.zero_grad(set_to_none=True)
            buffers, saved = self._buffers(model)
            loss, aux, grad_norm = self._loss_and_grads(state, batch)
            with span("trainer.fetch"):
                metrics = _fetch_scalars({"loss": loss, "grad_norm": grad_norm,
                                          **aux})
            self.host_syncs += 1
            finite = (np.isfinite(metrics["loss"])
                      and np.isfinite(metrics["grad_norm"]))
            if finite or not self.cfg.nan_guard:
                with span("trainer.update", device=self.device):
                    state.optimizer.update([p.grad
                                            for p in state.optimizer.params])
            elif saved is not None:
                with torch.no_grad():
                    for b, old in zip(buffers, saved.split(
                            [b.numel() for b in buffers])):
                        b.copy_(old.view_as(b))
            model.zero_grad(set_to_none=True)
            state.step += 1
        return metrics

    def train_steps(self, state: TrainState,
                    batches: list[dict[str, torch.Tensor]]
                    ) -> dict[str, float]:
        """``len(batches)`` steps in one call (``cfg.steps_per_call``, JAX's
        ``lax.scan`` of the step): the steps run back to back with no host
        sync between them, their metrics come back in one device -> host
        copy, and the means over the steps are returned, as JAX's scan
        returns them.

        The NaN guard is decided on the device: after each update, a step
        whose loss or gradient norm is not finite, or that follows one in
        the call, puts back the parameters, the optimizer's moments and the
        floating buffers that :meth:`Optimizer.hold` and :meth:`_buffers`
        copied before it (``torch.where`` on a device flag); ``step`` still
        advances. A step after a skipped one ran with the optimizer's host
        counters (the update count behind the LR, AdamW's bias corrections,
        the accumulation phase) as if nothing had been skipped, so once the
        copy shows a skip the host takes those counters back to the skipped
        step and trains the rest of the call again one :meth:`train_step`
        each. Each step thus does what :meth:`train_step` does, bit for
        bit; one batch is one :meth:`train_step`."""
        if len(batches) == 1:
            return self.train_step(state, batches[0])
        guard = self.cfg.nan_guard
        model, opt = state.model, state.optimizer
        live = torch.ones((), dtype=torch.bool, device=self.device)
        first_step, marks, rows, keys = state.step, [], [], None
        for batch in batches:
            with span("trainer.step", id=state.step,
                      rows=len(batch["image"])):
                model.zero_grad(set_to_none=True)
                buffers, saved = self._buffers(model)
                marks.append(opt.mark())
                loss, aux, grad_norm = self._loss_and_grads(state, batch)
                metrics = {"loss": loss, "grad_norm": grad_norm, **aux}
                keys = [k for k, v in metrics.items()
                        if torch.is_tensor(v) and v.dim() == 0]
                if guard:
                    live = (live & torch.isfinite(loss)
                            & torch.isfinite(grad_norm))
                    held = opt.hold()
                with span("trainer.update", device=self.device):
                    opt.update([p.grad for p in opt.params])
                if guard:
                    opt.keep_if(live, held)
                    if saved is not None:
                        with torch.no_grad():
                            for b, old in zip(buffers, saved.split(
                                    [b.numel() for b in buffers])):
                                torch.where(live, b, old.view_as(b), out=b)
                model.zero_grad(set_to_none=True)
                state.step += 1
                rows.append(torch.stack([metrics[k].float() for k in keys]
                                        + [live.float()]))
        with span("trainer.fetch"):
            values = torch.stack(rows).cpu().tolist()
        self.host_syncs += 1
        skipped = [j for j, row in enumerate(values) if not row[-1]]
        if skipped:
            j = skipped[0]
            opt.restore(marks[j])
            state.step = first_step + j + 1
            for i in range(j + 1, len(batches)):
                again = self.train_step(state, batches[i])
                values[i] = [again[k] for k in keys] + [1.0]
        means = np.mean(np.asarray(values, np.float64)[:, :-1], axis=0)
        return dict(zip(keys, means.tolist()))

    def _reduced_gradients(self, model: nn.Module
                           ) -> tuple[list[torch.Tensor], list[bool]]:
        """The gradients of the step (every parameter that has one; under
        expert parallelism a rank's own members and the replicated rest),
        averaged over the data group in place, and which of them this rank
        holds alone."""
        named = [(n, p) for n, p in model.named_parameters()
                 if p.grad is not None]
        grads = [p.grad for _, p in named]
        if self.mesh.data_group is not None:
            collectives.average_gradients_(grads, self.mesh.data_group,
                                           self.mesh.num_data)
        return grads, [self._owner[n] is not None for n, _ in named]

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
        self._apply_input_view(loader)
        totals = [torch.zeros((), dtype=dt, device=self.device)
                  for dt in (torch.float32, torch.int64, torch.int64)]
        with collectives.use_mesh(self.mesh):
            for i, batch in enumerate(loader):
                if limit and i >= limit:
                    break
                self._eval_step(state, self.stage(batch), totals)
        # the data group's totals (each rank evaluated its slice)
        loss_sum, correct, total = collectives.all_reduce_sum_(
            torch.stack([t.double() for t in totals]),
            self.mesh.data_group).cpu().tolist()
        if total == 0:
            raise ValueError(
                "evaluate: no valid samples (empty val split or every "
                "image masked); check train_split/data_dir")
        return {"val_loss": loss_sum / total, "val_acc": correct / total}

    # ------------------------------------------------------------------
    # the epoch loop
    # ------------------------------------------------------------------

    @property
    def logger(self):
        """The run's logger (``<log_dir>/<train_id>.log`` and stdout), made
        at first use so that a Trainer used only for steps writes no file."""
        return get_logger(self.cfg.train_id, self.cfg.log_dir)

    def _log_metrics(self, record: dict) -> None:
        if not self._is_main:
            return
        os.makedirs(os.path.dirname(self._metrics_path), exist_ok=True)
        with open(self._metrics_path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def _on_sigterm(self, signum, frame) -> None:
        self._preempted = True
        self.logger.warning("SIGTERM received: checkpointing at the next "
                            "step boundary and stopping.")

    def _agree_preempted(self) -> bool:
        """Whether any rank received SIGTERM: one all-reduce of a flag, so
        every rank breaks at the same step or none does (a lone leaver would
        leave the others waiting in their next collective). One process:
        its own flag."""
        if not self._multi:
            return self._preempted
        return collectives.agree_any(self._preempted, self.device)

    def _apply_input_view(self, loader) -> None:
        if loader is not None and hasattr(loader, "set_process_view"):
            loader.set_process_view(*self._input_view)

    def fit(self, train_loader, val_loader=None,
            resume: bool | str = True) -> list[dict]:
        """Train ``cfg.max_epochs`` epochs; returns the per-epoch records.

        ``resume``: a checkpoint directory to restore (new saves go to the
        run's own directory and partial saves are purged); ``True`` to
        continue from the newer of the run's last full save and its live
        mid-epoch save; ``False`` for a fresh lineage."""
        cfg = self.cfg
        self._apply_input_view(train_loader)
        steps_per_epoch = train_loader.steps_per_epoch()
        if cfg.limit_train_batches:
            steps_per_epoch = min(steps_per_epoch, cfg.limit_train_batches)
        k = max(1, cfg.steps_per_call)
        if k > 1 and steps_per_epoch % k:
            # the groups take whole k-batch runs of the loader; say so rather
            # than train fewer steps than the epoch's accounting claims
            dropped = steps_per_epoch % k
            self.logger.warning(
                "steps_per_call=%d does not divide %d steps/epoch: the last "
                "%d batch(es) of every epoch are dropped (drop_last-style; "
                "reshuffled each epoch)", k, steps_per_epoch, dropped)
            steps_per_epoch -= dropped
        self.state = self.init_state(steps_per_epoch)
        ckpt = CheckpointManager(cfg.checkpoint, cfg.train_id,
                                 mesh=self.mesh)
        # Mid-epoch preemption saves live in a `<run>_partial` sibling keyed
        # by global step (monotonic, so never a collision with a re-run of
        # the same epoch); only the newest is kept, and an abandoned
        # lineage's are purged so they never come back (nor outrank a fresh
        # save)
        partial = CheckpointManager(
            dataclasses.replace(cfg.checkpoint, monitor="steps_done",
                                mode="max", top_k=1, every_n_epochs=0,
                                async_save=False),
            cfg.train_id, directory=ckpt.directory + "_partial",
            mesh=self.mesh)

        start_epoch, resume_offset = 0, 0
        es_meta: dict | None = None  # early-stop state of the resumed save
        if isinstance(resume, str) and resume:
            src = CheckpointManager(cfg.checkpoint, cfg.train_id,
                                    directory=resume, mesh=self.mesh)
            if src.latest_epoch() is None:
                raise FileNotFoundError(f"No checkpoint under {resume}")
            src.restore(self.state)
            start_epoch = int(src.latest_epoch())
            es_meta = src.metrics(start_epoch)
            self.logger.info("Restored %s (epoch %d)", resume, start_epoch)
            partial.purge()  # an explicit restore starts a new lineage
        elif resume:
            # the newer of the full and the mid-epoch save, decided before
            # restoring either; a mid-epoch restore fast-forwards the loader
            # (per-step randomness is keyed by state.step, so augmentation
            # and mixup continue exactly)
            full_epoch = ckpt.latest_epoch()
            pstep = partial.latest_epoch()
            meta = partial.metrics(pstep) if pstep is not None else None
            p_epoch = int(meta.get("epoch_index", -1)) if meta else -1
            # a partial is live only at or after this lineage's full resume
            # point; with no full save only an epoch-0 partial is (a later
            # one is an orphan of a deleted run directory)
            partial_live = meta is not None and (
                p_epoch >= full_epoch if full_epoch is not None
                else p_epoch == 0)
            if partial_live:
                partial.restore(self.state)
                start_epoch = p_epoch
                resume_offset = int(meta.get("steps_done", 0))
                es_meta = meta
                self.logger.info(
                    "Resumed mid-epoch %d at batch %d (preemption "
                    "checkpoint, global step %d)",
                    start_epoch + 1, resume_offset, pstep)
                self._log_metrics({"resumed_mid_epoch": start_epoch + 1,
                                   "start_batch": resume_offset,
                                   "global_step": int(pstep)})
                # resume_offset == steps_per_epoch (preempted in the epoch's
                # last step): the epoch trains nothing and still runs val
                # and the full save the preempted run never wrote
            elif full_epoch is not None:
                ckpt.restore(self.state)
                start_epoch = int(full_epoch)
                es_meta = ckpt.metrics(start_epoch)
                self.logger.info("Resumed from epoch %d", start_epoch)
                if meta is not None:
                    partial.purge()  # older than the full save: stale
            elif meta is not None:
                partial.purge()  # orphan of a deleted lineage
        else:
            partial.purge()  # resume=False: a fresh lineage

        history: list[dict] = []
        best = -math.inf if cfg.early_stop_mode == "max" else math.inf
        since_best = 0
        sign = 1.0 if cfg.early_stop_mode == "max" else -1.0
        timeline: list[float] = []
        # the early-stop state travels with the checkpoint, so a resumed
        # run stops at the same epoch as an uninterrupted one
        es = (es_meta or {}).get("early_stop") or {}
        if es:
            timeline = [float(x) for x in es.get("timeline", [])]
            if es.get("best") is not None:
                best = float(es["best"])
            since_best = int(es.get("since_best", 0))

        def es_state() -> dict:
            out = {"since_best": since_best,
                   "timeline": timeline[-(cfg.early_stop_patience + 1):]}
            if math.isfinite(best):
                out["best"] = best
            return out

        self._preempted = False
        profiled = False
        with contextlib.ExitStack() as stack:
            # SIGTERM (a preempted or rescheduled machine) sets a flag; the
            # loop saves at the next step boundary and stops. The previous
            # handler comes back however fit() ends (SIG_DFL for one
            # installed outside Python).
            if threading.current_thread() is threading.main_thread():
                prev = signal.signal(signal.SIGTERM, self._on_sigterm)
                stack.callback(signal.signal, signal.SIGTERM,
                               prev if prev is not None else signal.SIG_DFL)
            stack.callback(ckpt.wait)
            for epoch in range(start_epoch, cfg.max_epochs):
                t0 = time.time()
                running, nsteps, consumed = 0.0, 0, 0
                # epoch means of every scalar the task emits; consumed
                # counts loader batches (the profiled window trains one
                # batch several times), which the resume offset must track
                aux_running: dict[str, float] = {}
                epoch_offset = resume_offset if epoch == start_epoch else 0
                if hasattr(train_loader, "set_epoch"):
                    train_loader.set_epoch(epoch, epoch_offset)
                elif epoch_offset:
                    self.logger.warning(
                        "loader has no set_epoch(); cannot fast-forward %d "
                        "batches — the first %d steps of epoch %d repeat.",
                        epoch_offset, epoch_offset, epoch + 1)

                def step(group) -> None:
                    # one call of k steps; its metrics are the k steps'
                    # means, so they count k times
                    nonlocal running, nsteps
                    fetched = self.train_steps(self.state, group)
                    running += fetched["loss"] * k
                    for mk, mv in fetched.items():
                        if mk != "loss":
                            aux_running[mk] = (aux_running.get(mk, 0.0)
                                               + mv * k)
                    nsteps += k

                batches = iter(train_loader)
                # SIGTERM is agreed and the limit applied once a group, and
                # the limit and the resume offset count loader batches
                for i, host_group in enumerate(_groups(batches, k)):
                    if self._agree_preempted():
                        # every rank breaks at the same step
                        self._preempted = True
                        break
                    if (cfg.limit_train_batches and epoch_offset + i * k
                            >= cfg.limit_train_batches):
                        break
                    group = [self.stage(b) for b in host_group]
                    if cfg.profile_dir and not profiled and i == 1:
                        # trace a few steady-state steps once per run
                        with trace(cfg.profile_dir):
                            for _ in range(cfg.profile_steps):
                                step(group)
                        profiled = True
                    else:
                        step(group)
                    consumed += k
                if hasattr(batches, "close"):
                    batches.close()  # release the loader's producer thread
                dt = time.time() - t0
                train_loss = running / max(nsteps, 1)
                # one more agreement an epoch, whichever way the loop ended:
                # a SIGTERM during a rank's last step must stop every rank
                # before the evaluation's and the save's collectives
                if self._agree_preempted():
                    self._preempted = True
                    done = epoch_offset + consumed
                    if nsteps:
                        partial.save(self.state.step, self.state,
                                     {"epoch_index": float(epoch),
                                      "steps_done": float(done),
                                      # mid-epoch early-stop state is that
                                      # of the last completed epoch
                                      "early_stop": es_state()})
                        self.logger.info(
                            "Preemption checkpoint saved mid-epoch %d (batch "
                            "%d/%d, global step %d).", epoch + 1, done,
                            steps_per_epoch, self.state.step)
                    self._log_metrics({"epoch": epoch + 1, "preempted": True,
                                       "steps": done})
                    break
                record = {
                    "epoch": epoch + 1,
                    "train_loss": train_loss,
                    "epoch_seconds": dt,
                    "images_per_second":
                        nsteps * cfg.global_batch_size / dt if dt else 0.0,
                }
                for mk, mv in aux_running.items():
                    record.setdefault(mk, mv / max(nsteps, 1))
                if val_loader is not None:
                    record.update(self.evaluate(val_loader, self.state,
                                                cfg.limit_val_batches))
                self.logger.info("epoch %d: %s", epoch + 1, " ".join(
                    f"{k}={v:.5g}" for k, v in record.items() if k != "epoch"))
                self._log_metrics(record)
                history.append(record)

                # update the early-stop state before the save that carries
                # it; the stop itself comes after the save
                metric_key = cfg.early_stop_monitor
                stop = False
                if metric_key in record:
                    cur = record[metric_key]
                    if cfg.early_stop_window:
                        timeline.append(cur)
                        stop = window_early_exit(timeline,
                                                 cfg.early_stop_patience,
                                                 cfg.early_stop_mode)
                    elif sign * cur > sign * best:
                        best, since_best = cur, 0
                    else:
                        since_best += 1
                        stop = bool(cfg.early_stop_patience and
                                    since_best >= cfg.early_stop_patience)
                metrics_for_ckpt = {k: v for k, v in record.items()
                                    if isinstance(v, (int, float))}
                if cfg.checkpoint.monitor not in metrics_for_ckpt:
                    # no val loader: train loss ranks the saves, sign-
                    # adjusted for the manager's mode; an epoch that trained
                    # no step (a boundary resume) ranks never-best
                    if nsteps:
                        fallback = (-train_loss if cfg.checkpoint.mode == "max"
                                    else train_loss)
                    else:
                        fallback = (-math.inf if cfg.checkpoint.mode == "max"
                                    else math.inf)
                    metrics_for_ckpt[cfg.checkpoint.monitor] = fallback
                metrics_for_ckpt["early_stop"] = es_state()
                ckpt.save(epoch + 1, self.state, metrics_for_ckpt)
                if stop:
                    self.logger.info(
                        "%s has not improved for %d epochs. Stopping training.",
                        metric_key, cfg.early_stop_patience)
                    break
        return history

    def test(self, test_loader, state: TrainState | None = None) -> dict[str, Any]:
        out = self.evaluate(test_loader, state)
        return {"test_loss": out["val_loss"], "test_acc": out["val_acc"]}
