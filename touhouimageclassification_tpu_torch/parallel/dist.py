"""Multi-process start-up over ``torch.distributed`` (counterpart of the JAX
package's ``parallel/dist.py``).

A run is multi-process when the caller names a coordinator, when
``JAX_COORDINATOR_ADDRESS`` or ``COORDINATOR_ADDRESS`` is set (the JAX
package's triggers), or when torchrun's ``MASTER_ADDR`` and ``WORLD_SIZE``
are set. Otherwise :func:`initialize_distributed` does nothing and returns
False. Each process is one rank with one device: ``cuda:<LOCAL_RANK>``
unless the caller names one; its backend is NCCL for a CUDA device and gloo
for the CPU, unless the caller names a backend. Nothing switches backend or
device on its own.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

# the only launch variables this module reads
LAUNCH_VARS = ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
               "MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
               "LOCAL_RANK")

_rank_device: torch.device | None = None


def _launch_vars() -> dict[str, str]:
    return {k: os.environ[k] for k in LAUNCH_VARS if k in os.environ}


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           backend: str | None = None,
                           device: str | torch.device | None = None,
                           timeout: float | None = None) -> bool:
    """Join the process group if the arguments or the launch variables ask
    for one; returns True when the run is multi-process.

    ``coordinator_address`` is ``host:port`` of rank 0 (``tcp://`` rendezvous;
    a ``file://`` or ``tcp://`` URL is taken as it is); without it torchrun's
    variables rendezvous (``env://``). The world size and rank come from the
    arguments, else ``WORLD_SIZE`` and ``RANK``. Idempotent: a staged CLI
    (``treevit --stage all``) calls it once per stage. ``timeout`` (seconds)
    bounds every collective."""
    global _rank_device
    env = _launch_vars()
    address = (coordinator_address or env.get("JAX_COORDINATOR_ADDRESS")
               or env.get("COORDINATOR_ADDRESS"))
    torchrun = "MASTER_ADDR" in env and "WORLD_SIZE" in env
    if address is None and not torchrun:
        return False
    if dist.is_initialized():
        return True
    world = (num_processes if num_processes is not None
             else int(env["WORLD_SIZE"]) if "WORLD_SIZE" in env else None)
    rank = (process_id if process_id is not None
            else int(env["RANK"]) if "RANK" in env else None)
    if world is None or rank is None:
        raise ValueError(
            "a multi-process run needs its world size and rank: pass "
            "num_processes and process_id (--num-processes, --process-id) "
            "or set WORLD_SIZE and RANK")
    if not 0 <= rank < world:
        raise ValueError(f"process_id {rank} outside [0, {world})")
    local = int(env.get("LOCAL_RANK", 0))
    if device is None:
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"LOCAL_RANK {local} has no CUDA device "
                f"({torch.cuda.device_count()} visible); pass device='cpu' "
                "(--device cpu) to run the ranks on the CPU")
        device = torch.device("cuda", local)
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if address is None:
        init_method = "env://"
    elif "://" in address:
        init_method = address
    else:
        init_method = f"tcp://{address}"
    kwargs = {}
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank, **kwargs)
    _rank_device = device
    return True


def rank_device() -> torch.device | None:
    """The device :func:`initialize_distributed` gave this rank (None
    before, or in a one-process run)."""
    return _rank_device if dist.is_initialized() else None


def world() -> tuple[int, int]:
    """(rank, world size); (0, 1) without a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def shutdown_distributed() -> None:
    """Leave the process group (a no-op without one)."""
    global _rank_device
    if dist.is_initialized():
        dist.destroy_process_group()
    _rank_device = None
