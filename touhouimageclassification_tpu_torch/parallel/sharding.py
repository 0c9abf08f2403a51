"""Which rank holds which parameter (counterpart of the JAX package's
``parallel/sharding.py``).

Data parallelism replicates every parameter. Expert parallelism splits the
member stacks of the mixtures, ``experts`` (ResMoE) and ``sons`` (TreeViT),
over the expert axis with the JAX package's rule: a stack of E members is
split when the number of shards S divides E, member i then belonging to
expert rank ``i // (E / S)``; otherwise the stack is replicated. The rule
reads a parameter's name, so the optimizer state, whose entries are keyed
by parameter, follows it too. A rank keeps no copy of the members it does
not hold: :func:`release_unowned` moves them to the meta device, so their
memory is freed and a read of one fails instead of seeing stale weights.
"""
from __future__ import annotations

EXPERT_STACK_KEYS = ("experts", "sons")


def owned_members(num_members: int, shards: int, expert_index: int) -> range:
    """The members of an ``num_members`` stack that expert rank
    ``expert_index`` of ``shards`` holds (all when the stack is
    replicated)."""
    if shards <= 1 or num_members % shards:
        return range(num_members)
    per = num_members // shards
    return range(expert_index * per, (expert_index + 1) * per)


def member_of(name: str) -> tuple[str, int] | None:
    """(stack key, member index) of a parameter name such as
    ``experts.3.layer.0.mlp.fc1.weight``; None off the stacks."""
    parts = name.split(".")
    for key, index in zip(parts, parts[1:]):
        if key in EXPERT_STACK_KEYS and index.isdigit():
            return key, int(index)
    return None


def owner(name: str, stack_sizes: dict[str, int], shards: int) -> int | None:
    """The expert rank that holds parameter ``name``, or None when every
    rank holds it (off the stacks, one shard, or a stack the shards do not
    divide). ``stack_sizes`` maps a stack key to its member count."""
    member = member_of(name)
    if member is None or shards <= 1:
        return None
    key, index = member
    n = stack_sizes[key]
    if n % shards:
        return None
    return index // (n // shards)


def stack_sizes(model) -> dict[str, int]:
    """Stack key -> member count for the ``nn.ModuleList`` stacks of
    ``model``."""
    return {key: len(getattr(model, key)) for key in EXPERT_STACK_KEYS
            if hasattr(model, key)}


def release_unowned(model, shards: int, expert_index: int) -> set[str]:
    """Move the stack members that expert rank ``expert_index`` of
    ``shards`` does not hold to the meta device; returns their state-dict
    names (those of members released before included)."""
    released = set()
    for key in EXPERT_STACK_KEYS:
        stack = getattr(model, key, None)
        if stack is None:
            continue
        owned = owned_members(len(stack), shards, expert_index)
        for i, member in enumerate(stack):
            if i not in owned:
                member.to("meta")
                released.update(f"{key}.{i}.{name}"
                                for name in member.state_dict())
    return released
