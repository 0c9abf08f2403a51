"""One rank of the port's multi-process CPU tests (gloo).

``python tests/torch_mp_child.py <mode> <rank> <world> <dir>``: the parent
test writes ``<dir>/spec.pt`` (what to run), starts one process a rank, and
reads each rank's ``<dir>/out<rank>.pt``. The ranks meet through a
``file://`` rendezvous in ``<dir>``, and every collective times out after
60 s, so a hang fails the test instead of stalling it. The child imports the
port only.

Modes:

- ``steps``: for each of the spec's runs, :meth:`Trainer.train_step` on
  this rank's rows of the run's global batches (the trainer's input view),
  after an eval-mode forward of the run's images; returns the fetched
  metrics, the logits, and the parameters and buffers this rank holds;
- ``fit``: :meth:`Trainer.fit` on an image folder, optionally sending
  SIGTERM to one rank after a given step; returns the history, the step and
  the parameters this rank holds;
- ``cli``: a training CLI's ``main`` with the multi-process flags.
"""
import os
import signal
import sys

import numpy as np
import torch

torch.set_num_threads(1)

from touhouimageclassification_tpu_torch.parallel import collectives  # noqa: E402
from touhouimageclassification_tpu_torch.parallel.dist import (  # noqa: E402
    initialize_distributed, shutdown_distributed)

TIMEOUT = 60.0


def _model(spec):
    from touhouimageclassification_tpu_torch import models

    family = getattr(models, spec["family"])
    return family(spec["model_cfg"], "float32", "cpu", param_dtype="float32")


def _task(spec):
    from touhouimageclassification_tpu_torch.train import tasks

    if spec.get("task") is None:
        return None
    name, *args = spec["task"]
    return getattr(tasks, name)(*args)


def _filter(spec):
    from touhouimageclassification_tpu_torch.train import treevit

    stage = spec.get("stage")
    return treevit._mask_for_stage(stage) if stage else None


def _trainer(spec):
    from touhouimageclassification_tpu_torch.train.trainer import Trainer

    return Trainer(spec["cfg"], model=_model(spec), task=_task(spec),
                   device="cpu", init_params=spec.get("init_params"),
                   param_filter=_filter(spec))


def _held(trainer):
    """The state this rank holds: its members and the replicated rest
    (parameters and buffers)."""
    held = {n for n, _ in trainer.model.named_parameters()
            if trainer._holds(n)}
    return {k: v.detach().clone() for k, v in trainer.model.state_dict().items()
            if k in held or k not in trainer._owner}


def _rows(batch, view):
    index, count = view
    b = len(next(iter(batch.values()))) // count
    return {k: v[index * b:(index + 1) * b] for k, v in batch.items()}


def _one_run(spec):
    trainer = _trainer(spec)
    state = trainer.init_state(4)
    view = trainer._input_view
    logits = None
    if spec.get("eval_images") is not None:
        images = _rows({"image": spec["eval_images"]}, view)["image"]
        model = state.model.eval()
        with torch.no_grad(), collectives.use_mesh(trainer.mesh):
            out = model(torch.from_numpy(images))
            logits = out[0] if isinstance(out, tuple) else out
    metrics = [trainer.train_step(state, trainer.stage(_rows(b, view)))
               for b in spec["batches"]]
    return {"metrics": metrics, "logits": logits, "view": view,
            "held": _held(trainer), "step": state.step,
            "released": {n for n, t in state.model.state_dict().items()
                         if t.is_meta},
            "data_index": trainer.mesh.data_index,
            "expert_index": trainer.mesh.expert_index}


def steps(spec, rank):
    return [_one_run(run) for run in spec["runs"]]


def fit(spec, rank):
    from touhouimageclassification_tpu_torch.data import (image_loader,
                                                          random_split,
                                                          scan_image_folder)

    trainer = _trainer(spec)
    cfg = trainer.cfg
    index = scan_image_folder(cfg.data_dir)
    tr, va = random_split(len(index), cfg.train_split, cfg.seed)
    train = image_loader(index, tr, batch_size=cfg.global_batch_size,
                         canvas=trainer.out_size, shuffle=True, seed=cfg.seed)
    val = image_loader(index, va, batch_size=cfg.global_batch_size,
                       canvas=trainer.out_size, drop_last=False)
    kill = spec.get("sigterm")  # (rank, after this many steps)
    if kill is not None and kill[0] == rank:
        step_fn = trainer.train_step

        def train_step(state, batch):
            out = step_fn(state, batch)
            if state.step == kill[1]:
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        trainer.train_step = train_step
    history = trainer.fit(train, val, resume=spec.get("resume", True))
    return {"history": history, "step": trainer.state.step,
            "held": _held(trainer)}


def cli(spec, rank, world, directory):
    import contextlib
    import importlib

    module = importlib.import_module(
        f"touhouimageclassification_tpu_torch.train.{spec['cli']}")
    argv = [*spec["argv"], "--coordinator", f"file://{directory}/rdzv_cli",
            "--num-processes", str(world), "--process-id", str(rank),
            "--device", "cpu"]
    with contextlib.chdir(spec["workdir"]):
        trainer = module.main(argv)
    return {"step": trainer.state.step, "held": _held(trainer),
            "expert_index": trainer.mesh.expert_index}


def main():
    mode, rank, world, directory = (sys.argv[1], int(sys.argv[2]),
                                    int(sys.argv[3]), sys.argv[4])
    spec = torch.load(os.path.join(directory, "spec.pt"), weights_only=False)
    if mode == "cli":
        out = cli(spec, rank, world, directory)
    else:
        initialize_distributed(f"file://{directory}/rdzv", world, rank,
                               device="cpu", timeout=TIMEOUT)
        out = {"steps": steps, "fit": fit}[mode](spec, rank)
    torch.save(out, os.path.join(directory, f"out{rank}.pt"))
    shutdown_distributed()


if __name__ == "__main__":
    np.seterr(all="ignore")
    main()
