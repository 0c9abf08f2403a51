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
- the NaN guard: when the loss or the gradient norm is not finite the
  optimizer update is skipped, parameters, optimizer state and the model's
  floating buffers (a ResNet's BatchNorm running statistics, which the
  forward updates in place) stay as they were, and ``step`` still
  advances. The buffers are copied on the device before the forward and put
  back only for a skipped step;
- loss, grad_norm and the task's scalars come back to the host in one
  device -> host copy (``_fetch_scalars``). That copy is the step's one sync,
  and the guard branches on the fetched values on the host;
- frozen parameters (``param_filter``, or ``full_finetune=False``) still get
  gradients, which count in ``grad_norm``, but no update and no decay.

Unlike the JAX package the state is updated in place: a :class:`TrainState`
owns the model, whose parameters are the training parameters, and the
optimizer. Batches come from :func:`..data.image_loader` (the numpy
``HostImageLoader`` for one process) and are uploaded with
:meth:`Trainer.stage`.

:meth:`Trainer.fit` is the JAX package's epoch loop for one process:
per-epoch records in ``<log_dir>/<train_id>/metrics.jsonl``, safetensors
checkpoints with the same retention (``train/checkpoint.py``), both
early-stop rules with their state saved in each checkpoint, the profiled
window, and exact resume: from an explicit path, or automatically from the
newer of the last full save and the mid-epoch ``<run>_partial`` save that
SIGTERM leaves, fast-forwarding the loader. ``steps_per_call > 1`` and the
multi-process parts (input views, the preemption agreement) are not
ported.
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
from ..utils.logging import get_logger
from ..utils.profiling import trace
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
                                 param_dtype="float32", device=self.device,
                                 seed=cfg.seed)
        self.model = model.to(self.device)
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
        self._metrics_path = os.path.join(cfg.log_dir, cfg.train_id,
                                          "metrics.jsonl")
        self._preempted = False

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

    def train_step(self, state: TrainState,
                   batch: dict[str, torch.Tensor]) -> dict[str, float]:
        """One NaN-guarded step on a staged batch; returns the fetched
        metrics (``loss``, ``grad_norm``, the task's scalars)."""
        images, labels, drop_seed, task_seed = self._inputs(state, batch)
        task_gen = torch.Generator(device=self.device).manual_seed(task_seed)
        model = state.model
        model.zero_grad(set_to_none=True)
        buffers = [b for b in model.buffers() if b.is_floating_point()]
        saved = (torch.cat([b.reshape(-1) for b in buffers]) if buffers
                 else None)
        devices = [self.device.index] if self.device.type == "cuda" else []
        with torch.random.fork_rng(devices=devices, enabled=self._dropout):
            if self._dropout:
                torch.manual_seed(drop_seed)
            outputs = self.task.forward(model, images, batch, True, task_gen)
            loss, aux = self.task.loss(outputs, labels)
            loss.backward()
        grad_norm = global_norm([p.grad for p in model.parameters()
                                 if p.grad is not None])
        metrics = _fetch_scalars({"loss": loss.detach(), "grad_norm": grad_norm,
                                  **aux})
        if np.isfinite(metrics["loss"]) and np.isfinite(metrics["grad_norm"]):
            state.optimizer.update([p.grad for p in state.optimizer.params])
        elif saved is not None:
            with torch.no_grad():
                for b, old in zip(buffers, saved.split(
                        [b.numel() for b in buffers])):
                    b.copy_(old.view_as(b))
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

    # ------------------------------------------------------------------
    # the epoch loop
    # ------------------------------------------------------------------

    @property
    def logger(self):
        """The run's logger (``<log_dir>/<train_id>.log`` and stdout), made
        at first use so that a Trainer used only for steps writes no file."""
        return get_logger(self.cfg.train_id, self.cfg.log_dir)

    def _log_metrics(self, record: dict) -> None:
        os.makedirs(os.path.dirname(self._metrics_path), exist_ok=True)
        with open(self._metrics_path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def _on_sigterm(self, signum, frame) -> None:
        self._preempted = True
        self.logger.warning("SIGTERM received: checkpointing at the next "
                            "step boundary and stopping.")

    def fit(self, train_loader, val_loader=None,
            resume: bool | str = True) -> list[dict]:
        """Train ``cfg.max_epochs`` epochs; returns the per-epoch records.

        ``resume``: a checkpoint directory to restore (new saves go to the
        run's own directory and partial saves are purged); ``True`` to
        continue from the newer of the run's last full save and its live
        mid-epoch save; ``False`` for a fresh lineage."""
        cfg = self.cfg
        if cfg.steps_per_call > 1:
            raise NotImplementedError(
                "steps_per_call > 1 (the lax.scan step fusion) is not ported "
                "(ROADMAP.md 'Not ported')")
        steps_per_epoch = train_loader.steps_per_epoch()
        if cfg.limit_train_batches:
            steps_per_epoch = min(steps_per_epoch, cfg.limit_train_batches)
        self.state = self.init_state(steps_per_epoch)
        ckpt = CheckpointManager(cfg.checkpoint, cfg.train_id)
        # Mid-epoch preemption saves live in a `<run>_partial` sibling keyed
        # by global step (monotonic, so never a collision with a re-run of
        # the same epoch); only the newest is kept
        partial = CheckpointManager(
            dataclasses.replace(cfg.checkpoint, monitor="steps_done",
                                mode="max", top_k=1, every_n_epochs=0,
                                async_save=False),
            cfg.train_id, directory=ckpt.directory + "_partial")

        def purge_partial() -> None:
            """Stale mid-epoch saves of an abandoned lineage must never
            come back (nor outrank a fresh save)."""
            for step in partial.all_steps():
                partial.delete(step)

        start_epoch, resume_offset = 0, 0
        es_meta: dict | None = None  # early-stop state of the resumed save
        if isinstance(resume, str) and resume:
            src = CheckpointManager(cfg.checkpoint, cfg.train_id,
                                    directory=resume)
            if src.latest_epoch() is None:
                raise FileNotFoundError(f"No checkpoint under {resume}")
            src.restore(self.state)
            start_epoch = int(src.latest_epoch())
            es_meta = src.metrics(start_epoch)
            self.logger.info("Restored %s (epoch %d)", resume, start_epoch)
            purge_partial()  # an explicit restore starts a new lineage
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
                    purge_partial()  # older than the full save: stale
            elif meta is not None:
                purge_partial()  # orphan of a deleted lineage
        else:
            purge_partial()  # resume=False: a fresh lineage

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

                def step(batch) -> None:
                    nonlocal running, nsteps
                    fetched = self.train_step(self.state, batch)
                    running += fetched["loss"]
                    for mk, mv in fetched.items():
                        if mk != "loss":
                            aux_running[mk] = aux_running.get(mk, 0.0) + mv
                    nsteps += 1

                batches = iter(train_loader)
                for i, host_batch in enumerate(batches):
                    if self._preempted:
                        break
                    if (cfg.limit_train_batches
                            and epoch_offset + i >= cfg.limit_train_batches):
                        break
                    batch = self.stage(host_batch)
                    if cfg.profile_dir and not profiled and i == 1:
                        # trace a few steady-state steps once per run
                        with trace(cfg.profile_dir):
                            for _ in range(cfg.profile_steps):
                                step(batch)
                        profiled = True
                    else:
                        step(batch)
                    consumed += 1
                if hasattr(batches, "close"):
                    batches.close()  # release the loader's producer thread
                dt = time.time() - t0
                train_loss = running / max(nsteps, 1)
                if self._preempted:
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
