"""The collectives of a multi-process step, and the mesh they run over.

:func:`use_mesh` makes a :class:`~.mesh.Mesh` the active one while a step
runs; the modules that reduce over the batch or over the experts read its
groups here, and run as one process does when there is none (or when the
axis has one rank). Every collective here is an
``all_reduce`` (of a sum), which gloo also takes on CUDA tensors.

The step's correctness rule: on P data ranks it computes what one process
computes on the whole global batch. So:

- a batch reduction of a loss or a statistic is a sum over the data group
  (:func:`sum_over_data`). Every rank then holds the global value, and its
  backward sums the incoming gradients over the group too, as it must where
  each rank's later computation uses its own rows (a BatchNorm's moments).
  A loss that every rank holds whole thus sends each rank P times its own
  share of the gradient, and the trainer's gradient all-reduce takes the
  mean over the data group;
- the members of an expert stack are split over the expert group, whose
  ranks hold the same rows. Each computes its members' outputs, zeros for
  the others, and :func:`sum_over_experts` adds them up. What follows is
  replicated over the group, so its backward hands each rank the gradient
  as it is: summing it, as ``torch.distributed.nn.functional.all_reduce``
  does, would count it once per expert rank. The replicated gate then gets
  its whole gradient on every expert rank, its balance loss counted once;
- random numbers drawn per sample are drawn for the global batch from the
  step's generator and each rank keeps its own rows (:func:`global_rows`),
  and the batch's roll by one crosses ranks (:func:`roll_rows`).
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Sequence

import torch
import torch.distributed as dist

from . import sharding
from .dist import rank_device

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("tic_mesh",
                                                         default=None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the active mesh inside the block."""
    token = _ACTIVE.set(mesh)
    yield mesh
    _ACTIVE.reset(token)


def data_group():
    mesh = _ACTIVE.get()
    return None if mesh is None else mesh.data_group


def expert_group():
    mesh = _ACTIVE.get()
    return None if mesh is None else mesh.expert_group


def data_shard() -> tuple[int, int]:
    """(this rank's data index, number of data ranks); (0, 1) without a
    data group."""
    mesh = _ACTIVE.get()
    if mesh is None or mesh.data_group is None:
        return 0, 1
    return mesh.data_index, mesh.num_data


def owned_members(num_members: int) -> range:
    """The members of a stack the active mesh's rank runs (all of them
    without expert parallelism)."""
    mesh = _ACTIVE.get()
    if mesh is None or mesh.expert_group is None:
        return range(num_members)
    return sharding.owned_members(num_members, mesh.num_expert,
                                  mesh.expert_index)


class _SumOverGroup(torch.autograd.Function):
    """all_reduce(sum) whose backward all-reduces the gradient (sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _SumReplicated(torch.autograd.Function):
    """all_reduce(sum) of partial results whose sum every rank then uses
    alike: the backward passes the gradient on unchanged."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def sum_over_data(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the active data group (``x`` itself without one)."""
    group = data_group()
    return x if group is None else _SumOverGroup.apply(x, group)


def sum_over_experts(x: torch.Tensor) -> torch.Tensor:
    """Partial results summed over the active expert group (``x`` itself
    without one)."""
    group = expert_group()
    return x if group is None else _SumReplicated.apply(x, group)


def stack_members(run: Callable[[int], torch.Tensor],
                  num_members: int) -> torch.Tensor:
    """``torch.stack([run(i) for i in members])``: under expert parallelism
    this rank runs only its members, the others' rows are zeros, and the
    stack is summed over the expert group."""
    owned = owned_members(num_members)
    if len(owned) == num_members:
        return torch.stack([run(i) for i in range(num_members)])
    outs = {i: run(i) for i in owned}
    first = next(iter(outs.values()))
    zeros = torch.zeros_like(first)
    return sum_over_experts(torch.stack(
        [outs.get(i, zeros) for i in range(num_members)]))


@torch.no_grad()
def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The data group's (P * B, ...) concatenation of every rank's (B, ...)
    ``x`` in data-rank order (``x`` without a group): an all-reduce of a
    buffer that is zero outside this rank's rows."""
    index, count = data_shard()
    if count == 1:
        return x
    buf = torch.zeros((count, *x.shape), dtype=x.dtype, device=x.device)
    buf[index] = x
    dist.all_reduce(buf, group=data_group())
    return buf.reshape(count * x.shape[0], *x.shape[1:])


def roll_rows(x: torch.Tensor) -> torch.Tensor:
    """``x.roll(1, dims=0)`` of the global batch: this rank's first row
    becomes the previous rank's last."""
    index, count = data_shard()
    if count == 1:
        return x.roll(1, dims=0)
    last = gather_rows(x[-1:])
    return torch.cat([last[(index - 1) % count][None], x[:-1]])


def global_rows(draw: Callable[[int], torch.Tensor], rows: int
                ) -> torch.Tensor:
    """``draw(n)`` makes n rows of random numbers; this draws the global
    batch's rows, so the generator moves as in one process, and returns this
    rank's ``rows``."""
    index, count = data_shard()
    if count == 1:
        return draw(rows)
    return draw(rows * count)[index * rows:(index + 1) * rows]


def global_count(local: int) -> int:
    """The global batch size of a step whose ranks each hold ``local``
    rows."""
    return local * data_shard()[1]


@torch.no_grad()
def all_reduce_sum_(t: torch.Tensor, group) -> torch.Tensor:
    """In-place all-reduce (sum) outside autograd; ``t`` itself without a
    group."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


@torch.no_grad()
def average_gradients_(grads: Sequence[torch.Tensor], group, count: int,
                       bucket_bytes: int = 1 << 27) -> None:
    """Replace each tensor of ``grads`` by its mean over ``group``: the
    tensors of one dtype are packed into flat buckets of at most
    ``bucket_bytes``, one all-reduce a bucket."""
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for tensors in by_dtype.values():
        buckets: list[list[torch.Tensor]] = [[]]
        size = 0
        for t in tensors:
            nbytes = t.numel() * t.element_size()
            if buckets[-1] and size + nbytes > bucket_bytes:
                buckets.append([])
                size = 0
            buckets[-1].append(t)
            size += nbytes
        for bucket in buckets:
            flat = torch.cat([t.reshape(-1) for t in bucket])
            dist.all_reduce(flat, group=group)
            flat.div_(count)
            for t, v in zip(bucket, flat.split([t.numel() for t in bucket])):
                t.copy_(v.view_as(t))


def agree_any(flag: bool, device: torch.device) -> bool:
    """Whether ``flag`` is set on any rank of the world: one all-reduce."""
    t = torch.tensor([int(flag)], dtype=torch.int32, device=device)
    dist.all_reduce(t)
    return bool(t.item())


def barrier() -> None:
    """Every rank of the world reaches this point: an all-reduce of one
    element on the rank's device (which every backend takes)."""
    agree_any(False, rank_device() or torch.device("cpu"))
