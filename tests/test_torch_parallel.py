"""The port's ``parallel/`` in one process, against the JAX package's.

- ``_view_from_owners`` is the JAX function's copy: the same source and the
  same answers (or errors) on the synthetic ownership maps of
  ``test_multiprocess_input.py``;
- the loader's process shards partition each global batch, and a ragged
  tail keeps every process in lockstep, as the JAX loader's do;
- the expert rule: member i of E goes to expert rank i // (E / S) when S
  divides E, which is where JAX's ``P('expert')`` on the stacked axis puts
  it; otherwise the stack is replicated;
- ``initialize_distributed``: no trigger, no process group; the triggers
  and their errors; idempotence; ``create_mesh`` keeps JAX's errors;
- the collectives and the models run as one process does without a mesh.
"""
import inspect

import numpy as np
import pytest
import torch

from fixtures import make_image_folder
from touhouimageclassification_tpu.data.loader import \
    HostImageLoader as JaxLoader
from touhouimageclassification_tpu.parallel import mesh as jmesh
from touhouimageclassification_tpu_torch.data import (image_loader,
                                                      scan_image_folder)
from touhouimageclassification_tpu_torch.parallel import (collectives, dist,
                                                          mesh, sharding)

torch.set_num_threads(1)

# the synthetic maps of test_multiprocess_input.py::test_view_from_owners_
# groupings: (owners, me, axis sizes)
GOOD = [({0: {(0,), (1,)}, 1: {(2,), (3,)}}, 0, [4]),
        ({0: {(0,), (1,)}, 1: {(2,), (3,)}}, 1, [4]),
        ({0: {(0,)}, 1: {(0,)}}, 1, [1]),
        *[({0: {(0,)}, 1: {(0,)}, 2: {(1,)}, 3: {(1,)}}, p, [2])
          for p in range(4)],
        ({0: {(0, 0), (0, 1)}, 1: {(1, 0), (1, 1)}}, 1, [2, 2])]
BAD = [({0: {(0,), (2,)}, 1: {(1,), (3,)}}, 0, [4], "contiguous"),
       ({0: {(0,), (1,), (2,)}, 1: {(3,)}}, 0, [4], "equal"),
       ({0: {(0,), (1,)}, 1: {(1,), (2,)}, 2: {(3,), (0,)}}, 0, [4], "tile"),
       ({0: {(0,)}}, 1, [1], "owns no devices")]


def test_view_from_owners_is_jaxs_copy():
    def body(fn):
        src = inspect.getsource(fn)
        return src.replace(fn.__doc__, "")
    assert body(mesh._view_from_owners) == body(jmesh._view_from_owners)


@pytest.mark.parametrize("owners,me,sizes", GOOD)
def test_view_from_owners_groupings_equal_jax(owners, me, sizes):
    assert mesh._view_from_owners(owners, me, sizes) == \
        jmesh._view_from_owners(owners, me, sizes)


@pytest.mark.parametrize("owners,me,sizes,match", BAD)
def test_view_from_owners_rejects_as_jax(owners, me, sizes, match):
    for fn in (mesh._view_from_owners, jmesh._view_from_owners):
        with pytest.raises(ValueError, match=match):
            fn(owners, me, sizes)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("mp_data")
    return make_image_folder(str(root), num_classes=3, per_class=7, size=16)


def _rows(batch):
    return [(int(batch["label"][j]), batch["image"][j].tobytes())
            for j in range(len(batch["mask"])) if batch["mask"][j]]


@pytest.mark.parametrize("count", [2, 4])
def test_process_shards_partition_each_global_batch(dataset, count):
    """Per step the union of the per-process batches is the one-process
    global batch, and each process's batch is the JAX loader's."""
    index = scan_image_folder(dataset)
    kw = dict(batch_size=4, canvas=(16, 16), shuffle=True, seed=3,
              drop_last=False)
    ref = list(image_loader(index, None, process_shard=(0, 1), **kw))
    parts = [list(image_loader(index, None, process_shard=(p, count), **kw))
             for p in range(count)]
    jparts = [list(JaxLoader(index, process_shard=(p, count), **kw))
              for p in range(count)]
    assert {len(p) for p in parts} == {len(ref)} and len(ref) > 1
    for i, rb in enumerate(ref):
        got = sorted(r for p in parts for r in _rows(p[i]))
        assert got == sorted(_rows(rb)), i
        for p, jp in zip(parts, jparts):
            assert p[i]["image"].shape == (4 // count, 16, 16, 3)
            for key in p[i]:
                np.testing.assert_array_equal(p[i][key], jp[i][key])


@pytest.mark.parametrize("drop_last,steps", [(False, 2), (True, 1)])
def test_ragged_tail_stays_lockstep(dataset, drop_last, steps):
    """A process whose share of the global tail is empty still yields an
    all-masked batch; drop_last drops the tail on every process alike."""
    index = scan_image_folder(dataset)
    parts = [list(image_loader(index, np.arange(9), batch_size=8,
                               canvas=(16, 16), process_shard=(p, 4),
                               drop_last=drop_last)) for p in range(4)]
    assert [len(p) for p in parts] == [steps] * 4
    if not drop_last:
        tails = [p[1] for p in parts]
        assert sum(int(t["mask"].sum()) for t in tails) == 1
        assert all(t["image"].shape == (2, 16, 16, 3) for t in tails)


@pytest.mark.parametrize("members,shards", [(4, 1), (4, 2), (4, 4), (8, 2),
                                            (3, 2), (2, 2)])
def test_expert_rule_is_jaxs(members, shards):
    """Member i belongs where ``P('expert')`` puts row i of JAX's stack:
    contiguous blocks of E / S; a stack S does not divide is replicated,
    as JAX's rule leaves it."""
    names = [f"experts.{i}.head.weight" for i in range(members)]
    sizes = {"experts": members}
    owners = [sharding.owner(n, sizes, shards) for n in names]
    if shards == 1 or members % shards:
        assert owners == [None] * members
        assert all(list(sharding.owned_members(members, shards, e))
                   == list(range(members)) for e in range(shards))
        return
    blocks = np.array_split(np.arange(members), shards)
    assert owners == [int(np.nonzero([i in b for b in blocks])[0][0])
                      for i in range(members)]
    for e in range(shards):
        assert list(sharding.owned_members(members, shards, e)) == \
            list(blocks[e])
    assert sharding.owner("gate.vit.head.weight", sizes, shards) is None
    assert sharding.owner("sons.1.head.bias", {"sons": members}, shards) == \
        1 // (members // shards)


@pytest.mark.parametrize("members,shards,index", [(4, 2, 0), (4, 2, 1),
                                                  (3, 2, 1), (4, 1, 0)])
def test_release_unowned_frees_the_other_ranks_members(members, shards,
                                                       index):
    """An expert rank keeps its own members and the gate; the others go to
    the meta device (no memory, and a forward through one raises); a stack
    the shards do not divide is kept whole."""
    from touhouimageclassification_tpu_torch.config import (MoEConfig,
                                                            ViTConfig)
    from touhouimageclassification_tpu_torch.models.resmoe import \
        MoEClassifier

    vit = ViTConfig(image_size=16, patch_size=8, hidden_size=16,
                    num_layers=1, num_heads=2, mlp_dim=32, num_classes=4)
    model = MoEClassifier(MoEConfig(num_experts=members, top_k=1,
                                    num_classes=4, expert_vit=vit),
                          "float32", "cpu", seed=0)
    names = set(model.state_dict())
    released = sharding.release_unowned(model, shards, index)
    owned = set(sharding.owned_members(members, shards, index))
    want = {n for n in names if sharding.member_of(n)
            and sharding.member_of(n)[1] not in owned}
    assert released == want
    assert {n for n, t in model.state_dict().items() if t.is_meta} == want
    assert sharding.release_unowned(model, shards, index) == want
    x = torch.zeros(1, 16, 16, 3)
    for i in range(members):
        if i in owned:
            assert model.experts[i](x).shape == (1, 4)
        else:
            with pytest.raises((RuntimeError, NotImplementedError)):
                model.experts[i](x)
    assert not any(t.is_meta for t in model.gate.state_dict().values())


def test_member_names_follow_the_stacks():
    assert sharding.member_of("experts.3.layer.0.mlp.fc1.weight") == \
        ("experts", 3)
    assert sharding.member_of("sons.0.head.bias") == ("sons", 0)
    assert sharding.member_of("gate.vit.head.bias") is None
    assert sharding.member_of("experts.head") is None


def test_initialize_distributed_without_a_trigger(monkeypatch):
    for name in dist.LAUNCH_VARS:
        monkeypatch.delenv(name, raising=False)
    assert dist.initialize_distributed() is False
    assert dist.world() == (0, 1) and dist.rank_device() is None
    assert mesh.process_input_view(mesh.create_mesh()) == (0, 1)


def test_launch_errors(monkeypatch):
    """A torchrun trigger without a device for its LOCAL_RANK raises (no
    move to the CPU); a coordinator without world size or rank raises."""
    for name in dist.LAUNCH_VARS:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("LOCAL_RANK", str(torch.cuda.device_count()))
    with pytest.raises(RuntimeError, match="LOCAL_RANK"):
        dist.initialize_distributed()
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.delenv("RANK")
    with pytest.raises(ValueError, match="world size and rank"):
        dist.initialize_distributed("127.0.0.1:1")
    with pytest.raises(ValueError, match="outside"):
        dist.initialize_distributed("127.0.0.1:1", 2, 2, device="cpu")


def test_one_rank_group_is_idempotent_and_meshes_as_jax(tmp_path):
    """One gloo rank through the file rendezvous: a second call is a no-op
    (a staged CLI calls it once a stage); the mesh keeps JAX's errors."""
    url = f"file://{tmp_path}/rdzv"
    try:
        assert dist.initialize_distributed(url, 1, 0, device="cpu",
                                           timeout=60)
        assert dist.initialize_distributed(url, 1, 0, device="cpu")
        assert dist.world() == (0, 1)
        assert dist.rank_device() == torch.device("cpu")
        m = mesh.create_mesh()
        assert (m.num_data, m.num_expert, m.data_group, m.expert_group) == \
            (1, 1, None, None)
        assert mesh.process_input_view(m) == (0, 1)
        with pytest.raises(ValueError, match="needs at least 2 devices"):
            mesh.create_mesh(num_expert=2)
        with pytest.raises(ValueError, match="= 2 devices, have 1"):
            mesh.create_mesh(num_data=2)
        assert collectives.agree_any(True, torch.device("cpu"))
        assert not collectives.agree_any(False, torch.device("cpu"))
    finally:
        dist.shutdown_distributed()
    assert dist.world() == (0, 1)


def test_collectives_without_a_mesh_are_one_process():
    x = torch.arange(12.0).reshape(4, 3)
    assert collectives.data_shard() == (0, 1)
    assert torch.equal(collectives.roll_rows(x), x.roll(1, dims=0))
    assert torch.equal(collectives.gather_rows(x), x)
    assert collectives.sum_over_data(x) is x
    assert collectives.sum_over_experts(x) is x
    assert collectives.global_count(4) == 4
    g = torch.Generator().manual_seed(0)
    want = torch.rand(4, generator=torch.Generator().manual_seed(0))
    assert torch.equal(collectives.global_rows(
        lambda n: torch.rand(n, generator=g), 4), want)
    stacked = collectives.stack_members(lambda i: x[i], 4)
    assert torch.equal(stacked, x)
    one = mesh.Mesh(num_data=1, num_expert=1, rank=0)
    with collectives.use_mesh(one):
        assert collectives.data_shard() == (0, 1)
        assert list(collectives.owned_members(3)) == [0, 1, 2]
    assert collectives.data_group() is None
