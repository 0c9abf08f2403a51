"""Training checkpoints in safetensors + JSON (counterpart of the JAX
package's ``train/checkpoint.py``, which writes Orbax).

One directory per epoch (per global step for the trainer's mid-epoch
``<run>_partial`` manager) under ``<cfg.directory>/<run_name>``:

- ``state.safetensors``: the model's state dict (parameters, and buffers
  where a model has them), then the ``torch.optim`` state under ``opt/<param name>/<key>``,
  then the :class:`~.optim.Optimizer`'s accumulator under ``acc/<param
  name>`` while an accumulation window is open;
- ``meta.json``: ``step``, the Optimizer's ``count`` and ``mini_step``, and
  the inner optimizer's ``param_groups``;
- ``metrics.json``: the metrics handed to :meth:`CheckpointManager.save`.

A save is written under a temporary name and renamed into place, so a save
that dies half way is never taken for a checkpoint. Retention is the JAX
package's: the union of the latest save, the top-k by ``cfg.monitor`` (the
latest k when ``monitor`` is empty) and the last k of the every-
``every_n_epochs`` saves, applied after every save as Orbax applies its
preservation policy. ``async_save`` copies the state to the host, then
writes and applies retention on one background thread; :meth:`wait` joins
it. Nothing is pickled.

The safetensors files are written here (:func:`save_safetensors`) and read
with the ``safetensors`` library: the library's writer copies each tensor
to ``bytes`` while it holds the interpreter lock, so a background save
stalls the training thread for that whole copy; handing each tensor's
buffer to ``write`` releases the lock for the copy to the file
(``tools/checkpoint_write_study.py`` times both).

Several processes (a manager given the trainer's ``mesh``) save together
and the checkpoint restores into any world size, as the JAX package's Orbax
saves do. Every rank calls :meth:`CheckpointManager.save`; the ranks of
the mesh's first data row write: the one at expert index 0 the replicated
state and its own experts into ``state.safetensors``, the one at expert
index e > 0 its own ``experts.{i}.*`` / ``sons.{i}.*`` members (and their
optimizer state) under those global names into
``state.expert<e>.safetensors``. Rank 0 writes ``meta.json`` after a
barrier, renames the directory into place and applies the retention, and a
last barrier lets every rank see it. Such a save is synchronous. A restore
reads every ``state*.safetensors`` of the directory and keeps what the
rank holds.

Serving reads weights directories of three kinds (:func:`weights_kind`): a
serving export (``params.safetensors`` + ``serving_meta.json``), bare
params (``params.safetensors`` alone) and one epoch directory of these
checkpoints, whose model tensors :func:`read_weights` gathers from every
state file.
"""
from __future__ import annotations

import json
import os
import shutil
import struct
import threading

import torch
from safetensors.torch import load_file

from ..config import CheckpointConfig
from ..parallel import collectives, sharding
from ..parallel.dist import world

STATE_FILE = "state.safetensors"
META_FILE = "meta.json"
METRICS_FILE = "metrics.json"
# a serving export directory (``train/cli.py::export_for_serving``)
SERVING_PARAMS = "params.safetensors"
SERVING_META = "serving_meta.json"
_TMP = ".tmp"


_SAFETENSORS_DTYPES = {
    torch.float64: "F64", torch.float32: "F32", torch.float16: "F16",
    torch.bfloat16: "BF16", torch.int64: "I64", torch.int32: "I32",
    torch.int16: "I16", torch.int8: "I8", torch.uint8: "U8",
    torch.bool: "BOOL"}


def save_safetensors(tensors: dict[str, torch.Tensor], path: str) -> None:
    """Contiguous CPU ``tensors`` -> a safetensors file: a little-endian
    u64 header size, the JSON header (dtype, shape and byte range of each
    tensor, padded with spaces to 8 bytes), then the tensors' bytes in
    header order, each handed to ``write`` as a buffer."""
    header, offset = {}, 0
    for name, t in tensors.items():
        end = offset + t.numel() * t.element_size()
        header[name] = {"dtype": _SAFETENSORS_DTYPES[t.dtype],
                        "shape": list(t.shape), "data_offsets": [offset, end]}
        offset = end
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for t in tensors.values():
            f.write(memoryview(t.reshape(-1).view(torch.uint8).numpy()))


def _latest(steps: list[int], n: int) -> list[int]:
    """The last ``n`` of ``steps`` (none for n = 0), as Orbax's LatestN."""
    return steps[max(len(steps) - n, 0):] if n > 0 else []


def kept_steps(cfg: CheckpointConfig,
               saved: list[tuple[int, dict]]) -> set[int]:
    """The steps the retention keeps of ``saved`` ((step, metrics) in step
    order): the latest; the top ``cfg.top_k`` by ``cfg.monitor`` (a stable
    sort, so the later of two equal values ranks higher; the latest
    ``top_k`` when ``monitor`` is empty); and the last ``top_k`` of the
    steps divisible by ``every_n_epochs`` (the reference keeps the 3 newest
    every-3rd-epoch saves, not every one)."""
    steps = [s for s, _ in saved]
    keep = set(_latest(steps, 1))
    if cfg.monitor:
        ranked = sorted(saved, key=lambda sm: float(sm[1][cfg.monitor]),
                        reverse=cfg.mode == "min")
        keep.update(_latest([s for s, _ in ranked], cfg.top_k))
    else:
        keep.update(_latest(steps, cfg.top_k))
    if cfg.every_n_epochs:
        periodic = [s for s in steps if s % cfg.every_n_epochs == 0]
        keep.update(periodic[-cfg.top_k:])
    return keep


def shard_file(expert_index: int) -> str:
    """The state file expert rank ``expert_index`` writes."""
    return (STATE_FILE if expert_index == 0 else
            f"state.expert{expert_index}.safetensors")


def state_tensors(state, keep=None) -> tuple[dict[str, torch.Tensor], dict]:
    """A :class:`~.trainer.TrainState` -> (host tensors, meta): parameters,
    ``opt/<name>/<key>`` and ``acc/<name>``; ``step``, ``count``,
    ``mini_step`` and the inner optimizer's ``param_groups``. ``keep``
    (a parameter or buffer name -> bool) limits the tensors to the names it
    keeps, the optimizer's entries following their parameter's."""
    opt = state.optimizer
    names = {id(p): n for n, p in state.model.named_parameters()}
    tensors = {n: t.detach() for n, t in state.model.state_dict().items()
               if keep is None or keep(n)}
    inner = opt.inner.state_dict()
    for i, per_param in inner["state"].items():
        for key, value in per_param.items():
            name = names[id(opt.params[i])]
            if torch.is_tensor(value) and (keep is None or keep(name)):
                tensors[f"opt/{name}/{key}"] = value
    for p, a in zip(opt.params, opt.acc or []):
        if keep is None or keep(names[id(p)]):
            tensors[f"acc/{names[id(p)]}"] = a
    host = {k: v.detach().to("cpu", copy=True).contiguous()
            for k, v in tensors.items()}
    meta = {"step": int(state.step), "count": opt.count,
            "mini_step": opt.mini_step,
            "param_groups": inner["param_groups"]}
    return host, meta


@torch.no_grad()
def load_state(state, tensors: dict[str, torch.Tensor], meta: dict):
    """Write checkpoint ``tensors`` and ``meta`` into ``state`` in place
    (the model's state dict copied onto its device, the optimizer's state
    loaded through ``load_state_dict``); returns ``state``."""
    opt = state.optimizer
    model_sd = state.model.state_dict()
    missing = [n for n in model_sd if n not in tensors]
    if missing:
        raise KeyError(f"checkpoint lacks parameters {missing[:5]}")
    for name, t in model_sd.items():
        if not t.is_meta:   # a member another expert rank holds
            t.copy_(tensors[name])
    names = {id(p): n for n, p in state.model.named_parameters()}
    per_param: dict[int, dict[str, torch.Tensor]] = {}
    for i, p in enumerate(opt.params):
        prefix = f"opt/{names[id(p)]}/"
        entries = {k[len(prefix):]: v for k, v in tensors.items()
                   if k.startswith(prefix)}
        if entries:
            per_param[i] = entries
    # the saved hyperparameters over this optimizer's own parameter lists
    # (another world size holds another set of parameters)
    groups = [dict(saved, params=mine["params"]) for saved, mine in zip(
        meta["param_groups"], opt.inner.state_dict()["param_groups"])]
    opt.inner.load_state_dict({"state": per_param, "param_groups": groups})
    acc = [tensors.get(f"acc/{names[id(p)]}") for p in opt.params]
    opt.acc = (None if acc[0] is None else
               [a.to(p.device) for a, p in zip(acc, opt.params)])
    opt.count, opt.mini_step = int(meta["count"]), int(meta["mini_step"])
    state.step = int(meta["step"])
    return state


class CheckpointManager:
    """Per-epoch saves of a :class:`~.trainer.TrainState` with the JAX
    package's retention, under ``directory`` (default
    ``<cfg.directory>/<run_name>``; created at the first save)."""

    def __init__(self, cfg: CheckpointConfig, run_name: str,
                 directory: str | None = None, mesh=None):
        self.cfg = cfg
        self.directory = os.path.abspath(
            directory if directory else os.path.join(cfg.directory, run_name))
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None
        self.mesh = mesh
        self._multi = world()[1] > 1
        self._rank0 = world()[0] == 0

    # -- what is on disk ------------------------------------------------

    def all_steps(self) -> list[int]:
        """Complete saves, in step order (a save still under its temporary
        name is not one)."""
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit())

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def latest_epoch(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def metrics(self, step: int) -> dict | None:
        path = os.path.join(self._path(step), METRICS_FILE)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def best_epoch(self) -> int | None:
        """The best step by ``cfg.monitor`` (ties: the later), or the latest
        when ``monitor`` is empty."""
        steps = self.all_steps()
        if not self.cfg.monitor or not steps:
            return self.latest_epoch()
        ranked = sorted(steps, key=lambda s: float(self.metrics(s)[
            self.cfg.monitor]), reverse=self.cfg.mode == "min")
        return ranked[-1]

    # -- save / restore -------------------------------------------------

    def save(self, epoch: int, state, metrics: dict) -> bool:
        """Save ``state`` as step ``epoch`` with ``metrics``; skipped (False)
        when a save at this step or a later one exists, as Orbax's
        ``should_save``. The device -> host copy is made here; the write
        runs on a background thread with ``cfg.async_save``."""
        self.wait()
        latest = self.latest_epoch()
        if latest is not None and latest >= epoch:
            return False
        metrics = {k: (float(v) if isinstance(v, (int, float)) else v)
                   for k, v in metrics.items()}
        if self._multi:
            self._save_together(epoch, state, metrics)
            return True
        tensors, meta = state_tensors(state)
        if self.cfg.async_save:
            self._thread = threading.Thread(
                target=self._write_guarded, args=(epoch, tensors, meta, metrics),
                name=f"checkpoint-{epoch}", daemon=False)
            self._thread.start()
        else:
            self._write(epoch, tensors, meta, metrics)
        return True

    def _save_together(self, epoch: int, state, metrics: dict) -> None:
        """The multi-process save: each writing rank its file, then rank 0
        the meta, the rename and the retention, between barriers."""
        mesh = self.mesh
        e = mesh.expert_index if mesh is not None else 0
        writes = mesh is None or mesh.data_index == 0
        sizes = sharding.stack_sizes(state.model)
        shards = mesh.num_expert if mesh is not None else 1

        def keep(name: str) -> bool:
            owner = sharding.owner(name, sizes, shards)
            return owner == e or (owner is None and e == 0)

        tensors, meta = state_tensors(state, keep) if writes else ({}, None)
        final = self._path(epoch)
        tmp = final + _TMP
        if self._rank0:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
        collectives.barrier()
        if writes:
            save_safetensors(tensors, os.path.join(tmp, shard_file(e)))
        collectives.barrier()
        if self._rank0:
            for name, obj in ((META_FILE, meta), (METRICS_FILE, metrics)):
                with open(os.path.join(tmp, name), "w") as f:
                    json.dump(obj, f)
            os.rename(tmp, final)
            self._retain()
        collectives.barrier()

    def _retain(self) -> None:
        saved = [(s, self.metrics(s)) for s in self.all_steps()]
        keep = kept_steps(self.cfg, saved)
        for s, _ in saved:
            if s not in keep:
                shutil.rmtree(self._path(s))

    def _write_guarded(self, *args) -> None:
        try:
            self._write(*args)
        except Exception as e:  # re-raised by wait()
            self._error = e

    def _write(self, epoch: int, tensors: dict, meta: dict,
               metrics: dict) -> None:
        os.makedirs(self.directory, exist_ok=True)
        final = self._path(epoch)
        tmp = final + _TMP
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        save_safetensors(tensors, os.path.join(tmp, STATE_FILE))
        for name, obj in ((META_FILE, meta), (METRICS_FILE, metrics)):
            with open(os.path.join(tmp, name), "w") as f:
                json.dump(obj, f)
        os.rename(tmp, final)
        self._retain()

    def read(self, epoch: int | None = None
             ) -> tuple[dict[str, torch.Tensor], dict]:
        """The host tensors of step ``epoch`` (default: the latest), from
        every state file of the save (each expert rank's members), and its
        meta."""
        epoch = epoch if epoch is not None else self.latest_epoch()
        if epoch is None:
            raise FileNotFoundError(f"No checkpoint under {self.directory}")
        path = self._path(epoch)
        with open(os.path.join(path, META_FILE)) as f:
            meta = json.load(f)
        return read_state_files(path), meta

    def restore(self, state, epoch: int | None = None):
        """Load step ``epoch`` (default: the latest) into ``state`` in
        place; returns it."""
        return load_state(state, *self.read(epoch))

    def delete(self, step: int) -> None:
        shutil.rmtree(self._path(step))

    def purge(self) -> None:
        """Remove every save. In a multi-process run every rank calls this
        together: what each read of the directory before is settled at a
        first barrier, rank 0 removes, and a second barrier follows."""
        if self._multi:
            collectives.barrier()
        if self._rank0:
            for step in self.all_steps():
                self.delete(step)
        if self._multi:
            collectives.barrier()

    def wait(self) -> None:
        """Join the background save, re-raising what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def close(self) -> None:
        self.wait()


def _is_state_file(name: str) -> bool:
    return name.startswith("state") and name.endswith(".safetensors")


def read_state_files(path: str) -> dict[str, torch.Tensor]:
    """Every ``state*.safetensors`` of the save directory ``path`` (each
    expert rank's members) in one dict."""
    tensors: dict[str, torch.Tensor] = {}
    for name in sorted(os.listdir(path)):
        if _is_state_file(name):
            tensors.update(load_file(os.path.join(path, name)))
    return tensors


def save_params(path: str, params: dict[str, torch.Tensor]) -> None:
    """Params-only safetensors file for serving."""
    save_safetensors({k: v.detach().to("cpu").contiguous()
                      for k, v in params.items()}, path)


def load_params(path: str) -> dict[str, torch.Tensor]:
    return load_file(path)


def weights_kind(path: str) -> str:
    """What the weights directory ``path`` holds: ``'export'`` (a serving
    export, ``serving_meta.json`` + ``params.safetensors``), ``'params'``
    (``params.safetensors`` alone, as ``utils.extract_ckpt`` and
    ``utils.convert`` write it) or ``'checkpoint'`` (one save of
    :class:`CheckpointManager`, ``meta.json`` + ``state*.safetensors``).
    Anything else raises ``FileNotFoundError`` naming the files looked
    for."""
    names = set(os.listdir(path))
    if SERVING_PARAMS in names:
        return "export" if SERVING_META in names else "params"
    if META_FILE in names and any(_is_state_file(n) for n in names):
        return "checkpoint"
    raise FileNotFoundError(
        f"{path} is not a serving export ({SERVING_META} + {SERVING_PARAMS}), "
        f"a bare params directory ({SERVING_PARAMS}) or a training "
        f"checkpoint ({META_FILE} + state*.safetensors)")


def read_weights(path: str) -> dict[str, torch.Tensor]:
    """The model's tensors in the weights directory ``path`` (see
    :func:`weights_kind`), as saved: ``params.safetensors``, or every state
    file of a training checkpoint without the optimizer's ``opt/*`` and
    the accumulator's ``acc/*``."""
    if weights_kind(path) == "checkpoint":
        return {k: v for k, v in read_state_files(path).items()
                if not k.startswith(("opt/", "acc/"))}
    return load_params(os.path.join(path, SERVING_PARAMS))
