"""The device half of a train step as one captured CUDA graph, replayed
step after step by :meth:`..trainer.Trainer.train_step`.

A :class:`StepGraph` holds the graph and the tensors it reads and writes in
place: the static batch that each staged batch is copied into, the step's
CutMix/MixUp draw as a device vector (:func:`..ops.mixup.mix_params`), the
augmentation's and the task's generators (registered with the graph and
re-seeded before each replay, so that a replay draws what the eager step
draws), the stacked 0-d metrics that the guard fetches, the gradients that
the eager update takes, and the device spans opened during the capture
(:class:`~..utils.profiling.GraphSpans`: the trainer's phases and the
model's own, each a pair of timing events recorded as graph nodes), which
the trainer enters into the record after a profiled replay.

The port's launch counters (``ops.attention``, ``ops.patch_embed``,
``ops.layernorm``) count on the host when a kernel is launched. A kernel
recorded into a graph does not run at capture, so :func:`captured_launches`
takes the capture's launches back off the counters, and each
:meth:`StepGraph.replay` adds them again: the counters keep counting
kernels that ran.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable

import torch

from ..ops import attention, layernorm, patch_embed
from ..utils.profiling import GraphSpans

# the modules whose kernels a step launches, each naming its counters in
# LAUNCH_COUNTERS: an int counts launches, a dict counts them by route
_COUNTED = (attention, patch_embed, layernorm)


def engages(device: torch.device, processes: int) -> bool:
    """Whether a train step on ``device`` in a run of ``processes``
    processes replays a graph: on a CUDA device in one process (a capture
    holds no collective)."""
    return device.type == "cuda" and processes == 1


def launch_counts() -> dict[tuple, int]:
    """Every launch counter of the port's kernels, flat: ``(module, name)``
    for a count, ``(module, name, route)`` for a count by route."""
    counts = {}
    for module in _COUNTED:
        for name in module.LAUNCH_COUNTERS:
            value = getattr(module, name)
            if isinstance(value, dict):
                counts.update({(module.__name__, name, route): n
                               for route, n in value.items()})
            else:
                counts[(module.__name__, name)] = value
    return counts


def add_launches(counts: dict[tuple, int], sign: int = 1) -> None:
    """Add ``sign`` times ``counts`` (keys of :func:`launch_counts`) to the
    counters."""
    modules = {module.__name__: module for module in _COUNTED}
    for key, n in counts.items():
        module = modules[key[0]]
        if len(key) == 3:
            getattr(module, key[1])[key[2]] += sign * n
        else:
            setattr(module, key[1], getattr(module, key[1]) + sign * n)


@contextlib.contextmanager
def captured_launches():
    """Yields a dict that, after the block, holds the launches counted
    inside it, which are taken back off the counters (however the block
    ends): a capture records kernels but runs none."""
    before = launch_counts()
    launches: dict[tuple, int] = {}
    try:
        yield launches
    finally:
        after = launch_counts()
        launches.update({k: n - before.get(k, 0) for k, n in after.items()
                         if n != before.get(k, 0)})
        add_launches(launches, -1)


@dataclasses.dataclass
class StepGraph:
    """One captured step of one batch shape."""
    graph: Any
    batch: dict[str, torch.Tensor]
    mix: torch.Tensor | None
    generators: tuple[torch.Generator, ...]   # augmentation, task
    keys: list[str]
    scalars: torch.Tensor
    grads: list[torch.Tensor | None]          # the optimizer's parameters'
    outputs: list[torch.Tensor]               # every gradient, held
    launches: dict[tuple, int]
    spans: GraphSpans

    def replay(self) -> None:
        self.graph.replay()
        add_launches(self.launches)


def capture(body: Callable[[], Any], device: torch.device, pool,
            generators=()) -> tuple[Any, Any, dict[tuple, int]]:
    """``(graph, body's result, launches recorded)`` of ``body`` captured by
    ``torch.cuda.graph`` (on its side stream, after ``empty_cache``, so that
    the graph's pool has the room the eager step held) into the memory
    ``pool``, the ``generators`` registered with the graph. Raises what the
    capture raises, with ``device``'s stream as it was."""
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    stream = torch.cuda.current_stream(device)
    try:
        with captured_launches() as launches, torch.cuda.graph(
                graph, pool=pool, capture_error_mode="thread_local"):
            out = body()
    except BaseException:
        # a capture_end that raises leaves the capture stream current
        torch.cuda.set_stream(stream)
        _end_generator_capture(device)
        raise
    return graph, out, launches


def _end_generator_capture(device: torch.device) -> None:
    """A capture that fails leaves the generators it held in capture mode,
    the device's default generator among them, and their next eager draw
    raises. A capture of one small op that ends takes the default generator
    out of it (the failed capture's own generators are dropped)."""
    one = torch.zeros(1, device=device)
    with torch.cuda.graph(torch.cuda.CUDAGraph(),
                          capture_error_mode="thread_local"):
        one.add_(1)
