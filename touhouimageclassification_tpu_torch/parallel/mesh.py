"""The (data, expert) grid of ranks (counterpart of the JAX package's
``parallel/mesh.py``).

One process is one rank with one device. :func:`create_mesh` lays the first
``num_data * num_expert`` ranks out as the JAX package lays devices out,
``ranks.reshape(num_data, num_expert)``: rank r sits at data index
``r // num_expert`` and expert index ``r % num_expert``. Each axis of size
greater than one gets a process group per line of the grid: the data group
of a rank holds the ranks with its expert index (they split the batch), the
expert group the ranks with its data index (they hold the same rows and
split the experts). Every rank builds every group, in one order, as
``torch.distributed.new_group`` requires.

:func:`process_input_view` gives the slice of each global batch a rank
loads: ranks of one expert group load the same rows, so a pure
expert-parallel grid (data=1) gives every rank (0, 1).
"""
from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch.distributed as dist

from .dist import world


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the grid and the groups of its two axes (None
    for an axis of size one, which needs no collective)."""

    num_data: int
    num_expert: int
    rank: int
    data_group: object = None
    expert_group: object = None

    @property
    def data_index(self) -> int:
        return self.rank // self.num_expert

    @property
    def expert_index(self) -> int:
        return self.rank % self.num_expert


def create_mesh(num_data: int | None = None, num_expert: int = 1) -> Mesh:
    """A (data, expert) grid over the ranks of the process group (one rank
    without one). ``num_data=None`` uses every rank the expert axis leaves.
    """
    rank, size = world()
    if num_data is None:
        num_data = size // num_expert
    if num_data < 1 or num_expert < 1:
        raise ValueError(
            f"mesh ({num_data} data x {num_expert} expert) needs at least "
            f"{max(num_expert, 1)} devices, have {size}")
    if num_data * num_expert > size:
        raise ValueError(
            f"mesh ({num_data} data x {num_expert} expert) = "
            f"{num_data * num_expert} devices, have {size}")
    if num_data * num_expert < size:
        logging.getLogger(__name__).warning(
            "mesh (%d data x %d expert) uses %d of %d devices; the rest idle",
            num_data, num_expert, num_data * num_expert, size)
    grid = np.arange(num_data * num_expert).reshape(num_data, num_expert)
    data_group = expert_group = None
    if num_data > 1:
        for e in range(num_expert):
            g = dist.new_group(grid[:, e].tolist())
            if rank in grid[:, e]:
                data_group = g
    if num_expert > 1:
        for d in range(num_data):
            g = dist.new_group(grid[d].tolist())
            if rank in grid[d]:
                expert_group = g
    return Mesh(num_data, num_expert, rank, data_group, expert_group)


def process_input_view(mesh: Mesh) -> tuple[int, int]:
    """(shard_index, num_shards) of THIS rank's slice of a global batch
    split over the data axis; (0, 1) for one process."""
    rank, size = world()
    if size == 1:
        return (0, 1)
    owners = {r: {(r // mesh.num_expert,)}
              for r in range(mesh.num_data * mesh.num_expert)}
    return _view_from_owners(owners, rank, [mesh.num_data])


def _view_from_owners(owners: dict, me: int, axis_sizes) -> tuple[int, int]:
    """Pure core of :func:`process_input_view`: group processes by the
    batch-axis coordinate sets their devices cover and return
    (group_index_of_me, group_count). Unit-testable with synthetic
    ownership maps (a real grouped layout needs 4+ processes)."""
    if me not in owners:
        raise ValueError(
            "this process owns no devices in the mesh, so it has no input "
            "shard to load; build the mesh over devices of every "
            "participating process (or exclude this process from the run)"
        )

    def ranks(group):
        return sorted(int(np.ravel_multi_index(c, axis_sizes)) for c in group)

    groups = sorted({frozenset(v) for v in owners.values()},
                    key=lambda g: min(ranks(g)))
    union = set().union(*groups)
    contiguous = all(
        r[-1] - r[0] + 1 == len(r) for r in (ranks(g) for g in groups)
    )
    if (len({len(g) for g in groups}) != 1
            or sum(len(g) for g in groups) != len(union)
            or not contiguous):
        raise ValueError(
            "device-to-process layout does not tile the batch axis into "
            "equal, disjoint, contiguous process groups; re-order mesh "
            f"devices so each host owns a contiguous slab (got groups "
            f"{[ranks(g) for g in groups]})"
        )
    mine = frozenset(owners[me])
    return (groups.index(mine), len(groups))
