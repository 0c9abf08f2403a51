"""Weight conversion for the port's ViT, ResNet, ResMoE and TreeViT.

- :func:`from_jax_params` maps a parameter tree in the JAX package's layout
  (numpy arrays, Dense kernels laid out (in, out), conv kernels HWIO) onto
  the port's state dict: a ViT's ``params``, or a ResNet's ``(params,
  {'batch_stats': ...})`` (or its variables dict). It is the bridge every
  parity test uses, and the one layout bridge of the loaders.
- :func:`load_vit_weights` reads a reference or HF ViT checkpoint
  (``.pth``, ``.pt``, ``.bin`` or ``.safetensors``), converts it to that
  tree with :func:`torch_vit_to_flax`, then applies
  :func:`from_jax_params`; :func:`load_resnet_weights` does the same for a
  reference or torchvision ResNet through :func:`torch_resnet_to_flax`
  (which drops torchvision's ``num_batches_tracked``). A classifier whose
  size disagrees with the class count is drawn afresh there, as the JAX
  package draws it (``ignore_mismatched_sizes``). :func:`read_checkpoint`
  + :func:`convert_checkpoint` do the same for any family, picked by the
  model's config.
- ResMoE and TreeViT: :func:`from_jax_params` takes the JAX package's tree
  (``{'gate': {'vit': ...}, 'experts': stacked}`` or ``{'root': ...,
  'sons': stacked}``, the members stacked on a leading axis) to the state
  dict of ``gate.vit.*`` + ``experts.{i}.*`` or ``root.*`` + ``sons.{i}.*``
  through the ViT mapping. A reference checkpoint (``TIC/ResMoE/model.py``,
  ``TIC/TreeViT/model.py``: HF ViTs under those names) goes through
  :func:`torch_moe_to_flax` / :func:`torch_treevit_to_flax`;
  :func:`member_overrides` reads its member count, which the config does
  not hold, so that a loader builds the model to match.
- :func:`convert_and_save` (the CLI) writes a reference checkpoint of any
  family as ``<out_dir>/params.safetensors``, a bare params directory that
  ``infer.serve`` loads with ``--model``.

``_strip_prefixes``, ``torch_vit_to_flax``, ``torch_resnet_to_flax``,
``_normalize_ckpt``, ``member_overrides``, ``torch_moe_to_flax`` and
``torch_treevit_to_flax`` are the port's copies of the JAX package's
(``utils/convert.py``), with the same names and results
(``tests/test_torch_copies.py``, ``tests/test_torch_moe.py``).
"""
from __future__ import annotations

import os
import re
from typing import Any, Mapping

import numpy as np
import torch

import dataclasses

from ..config import MoEConfig, ResNetConfig, TreeViTConfig, ViTConfig
from .pretrained import _load_state_dict


def _np(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t,
                      dtype=np.float32)


def _strip_prefixes(sd: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """Normalize key prefixes across the reference's checkpoint styles
    (bare HF, Lightning's ``vit.``-prefixed module, ``model.`` wrappers)."""
    out = {k: v for k, v in sd.items()}
    for prefix in ("model.", "module."):
        if all(k.startswith(prefix) for k in out):
            out = {k[len(prefix):]: v for k, v in out.items()}
    # Lightning ViTLModule: self.vit = HF model -> keys 'vit.vit.*' and
    # 'vit.classifier.*'; bare HF keys are 'vit.*' and 'classifier.*'.
    if any(k.startswith("vit.vit.") for k in out):
        out = {k[len("vit."):]: v for k, v in out.items() if k.startswith("vit.")}
    # Bare ViTModel snapshots (google/vit-*-in21k): keys 'embeddings.*',
    # 'encoder.*', 'layernorm.*' with no 'vit.' prefix and no classifier —
    # normalize to the ViTForImageClassification layout. 'pooler.*' weights
    # have no counterpart in the classifier model and are dropped.
    if any(k.startswith("embeddings.") for k in out) and not any(
        k.startswith("vit.") for k in out
    ):
        out = {
            ("vit." + k): v for k, v in out.items() if not k.startswith("pooler.")
        }
    return out


def torch_vit_to_flax(
    state_dict: Mapping[str, Any],
    num_classes: int,
    head_init_seed: int = 0,
) -> dict:
    """HF ``ViTForImageClassification`` torch state dict -> the JAX
    package's ViT parameter tree (numpy; :func:`from_jax_params` carries it
    into the port). Infers depth/width from the keys."""
    sd = {k: _np(v) for k, v in _strip_prefixes(state_dict).items()}

    hidden = sd["vit.embeddings.cls_token"].shape[-1]
    layers = sorted(
        {int(m.group(1)) for k in sd
         if (m := re.match(r"vit\.encoder\.layer\.(\d+)\.", k))}
    )

    params: dict[str, Any] = {
        "cls_token": sd["vit.embeddings.cls_token"],
        "pos_embed": sd["vit.embeddings.position_embeddings"],
        "patch_embed": {"proj": {
            # conv OIHW (H,3,P,P) -> flat (ph, pw, c) x out
            "kernel": sd["vit.embeddings.patch_embeddings.projection.weight"]
            .transpose(2, 3, 1, 0).reshape(-1, hidden),
            "bias": sd["vit.embeddings.patch_embeddings.projection.bias"],
        }},
        "final_ln": {
            "scale": sd["vit.layernorm.weight"],
            "bias": sd["vit.layernorm.bias"],
        },
    }
    for i in layers:
        p = f"vit.encoder.layer.{i}."
        qkv_kernel = np.concatenate(
            [sd[p + f"attention.attention.{n}.weight"].T for n in ("query", "key", "value")],
            axis=1,
        )
        qkv_bias = np.concatenate(
            [sd[p + f"attention.attention.{n}.bias"] for n in ("query", "key", "value")]
        )
        params[f"layer_{i}"] = {
            "ln1": {"scale": sd[p + "layernorm_before.weight"],
                    "bias": sd[p + "layernorm_before.bias"]},
            "ln2": {"scale": sd[p + "layernorm_after.weight"],
                    "bias": sd[p + "layernorm_after.bias"]},
            "attn": {
                "qkv": {"kernel": qkv_kernel, "bias": qkv_bias},
                "out": {"kernel": sd[p + "attention.output.dense.weight"].T,
                        "bias": sd[p + "attention.output.dense.bias"]},
            },
            "mlp": {
                "fc1": {"kernel": sd[p + "intermediate.dense.weight"].T,
                        "bias": sd[p + "intermediate.dense.bias"]},
                "fc2": {"kernel": sd[p + "output.dense.weight"].T,
                        "bias": sd[p + "output.dense.bias"]},
            },
        }

    head_w = sd.get("classifier.weight")
    if head_w is not None and head_w.shape[0] == num_classes:
        params["head"] = {"kernel": head_w.T, "bias": sd["classifier.bias"]}
    else:
        # ignore_mismatched_sizes: fresh head, HF initializer_range=0.02
        rng = np.random.default_rng(head_init_seed)
        params["head"] = {
            "kernel": rng.normal(0.0, 0.02, (hidden, num_classes)).astype(np.float32),
            "bias": np.zeros((num_classes,), np.float32),
        }
    return params


def torch_resnet_to_flax(
    state_dict: Mapping[str, Any], num_classes: int
) -> tuple[dict, dict]:
    """Reference/torchvision ResNet state dict -> (params, batch_stats) for
    the JAX package's ``ResNet``."""
    sd = {k: _np(v) for k, v in _strip_prefixes(state_dict).items()}
    params: dict[str, Any] = {}
    stats: dict[str, Any] = {}

    def put(tree, path, leaf):
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = leaf

    def conv(src):
        return {"kernel": sd[src + ".weight"].transpose(2, 3, 1, 0)}

    def bn(src, dst):
        put(params, dst + ("scale",), sd[src + ".weight"])
        put(params, dst + ("bias",), sd[src + ".bias"])
        put(stats, dst + ("mean",), sd[src + ".running_mean"])
        put(stats, dst + ("var",), sd[src + ".running_var"])

    put(params, ("stem_conv", "kernel"), conv("conv1")["kernel"])
    bn("bn1", ("stem_bn",))

    stage_blocks: dict[int, int] = {}
    for k in sd:
        m = re.match(r"layer(\d)\.(\d+)\.", k)
        if m:
            s, b = int(m.group(1)), int(m.group(2))
            stage_blocks[s] = max(stage_blocks.get(s, 0), b + 1)

    for s, nblocks in sorted(stage_blocks.items()):
        for b in range(nblocks):
            src = f"layer{s}.{b}"
            dst = f"stage{s}_block{b}"
            n_convs = 3 if f"{src}.conv3.weight" in sd else 2
            for j in range(1, n_convs + 1):
                put(params, (dst, f"conv{j}", "kernel"), conv(f"{src}.conv{j}")["kernel"])
                bn(f"{src}.bn{j}", (dst, f"bn{j}"))
            if f"{src}.downsample.0.weight" in sd:
                put(params, (dst, "downsample_conv", "kernel"),
                    conv(f"{src}.downsample.0")["kernel"])
                bn(f"{src}.downsample.1", (dst, "downsample_bn"))

    fc_w = sd.get("fc.weight")
    if fc_w is not None and fc_w.shape[0] == num_classes:
        params["head"] = {"kernel": fc_w.T, "bias": sd["fc.bias"]}
    else:
        rng = np.random.default_rng(0)
        # feature width = channels of the last stage's final BN
        last_stage = max(stage_blocks)
        last_block = stage_blocks[last_stage] - 1
        n_convs = 3 if f"layer{last_stage}.{last_block}.conv3.weight" in sd else 2
        width = sd[f"layer{last_stage}.{last_block}.bn{n_convs}.weight"].shape[0]
        params["head"] = {
            "kernel": rng.normal(0.0, 0.02, (width, num_classes)).astype(np.float32),
            "bias": np.zeros((num_classes,), np.float32),
        }
    return params, {"batch_stats": stats}


def _subdict(sd: Mapping[str, Any], prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _stack_trees(trees: list) -> dict:
    """Stack per-member parameter trees leaf-wise onto a leading axis (the
    JAX package's ``nn.vmap`` layout of the experts and sons)."""
    if isinstance(trees[0], dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def _index_tree(tree, i: int):
    """Member ``i`` of a tree stacked on a leading axis."""
    if isinstance(tree, Mapping):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _member_ids(sd: Mapping[str, Any], name: str) -> list[int]:
    ids = sorted(
        {int(m.group(1)) for k in sd
         if (m := re.match(rf"{name}\.(\d+)\.", k))}
    )
    if not ids or ids != list(range(len(ids))):
        raise ValueError(
            f"checkpoint has no contiguous '{name}.N.*' keys "
            f"(found indices {ids}) — not a reference "
            f"{'MoEClassifier' if name == 'experts' else 'TreeModule'} "
            "state dict?"
        )
    return ids


def member_overrides(state_dict: Mapping[str, Any], model_type: str) -> dict:
    """Config overrides inferred from a reference MoE/TreeViT state dict —
    the expert/son count lives in the checkpoint, not the config, so loaders
    rebuild the model to match. ``{}`` for other model types."""
    mt = model_type.lower().replace("_", "-")
    if mt in ("vit-moe", "resmoe"):
        return {"num_experts": len(_member_ids(_strip_prefixes(state_dict),
                                               "experts"))}
    if mt in ("tree-vit", "treevit"):
        return {"num_categories": len(_member_ids(_strip_prefixes(state_dict),
                                                  "sons"))}
    return {}


def torch_moe_to_flax(state_dict: Mapping[str, Any], num_classes: int) -> dict:
    """Reference ``MoEClassifier`` state dict (``experts.{i}.*`` HF ViTs,
    ``gate.vit.*`` the gate's HF ViT scoring the experts) -> the JAX
    package's ResMoE tree (gate ViT under ``gate/vit``, experts stacked on a
    leading axis); a mismatched expert head is drawn with seed ``i``."""
    sd = _strip_prefixes(dict(state_dict))
    expert_ids = _member_ids(sd, "experts")
    gate = torch_vit_to_flax(_subdict(sd, "gate.vit."),
                             num_classes=len(expert_ids))
    experts = [
        torch_vit_to_flax(_subdict(sd, f"experts.{i}."), num_classes,
                          head_init_seed=i)
        for i in expert_ids
    ]
    return {"gate": {"vit": gate}, "experts": _stack_trees(experts)}


def torch_treevit_to_flax(state_dict: Mapping[str, Any],
                          num_classes: int) -> dict:
    """Reference ``TreeModule`` state dict (``root.*`` HF ViT scoring
    categories, ``sons.{i}.*`` HF ViTs scoring classes) -> the JAX package's
    TreeViT tree (root ViT + sons stacked on a leading axis)."""
    sd = _strip_prefixes(dict(state_dict))
    son_ids = _member_ids(sd, "sons")
    root = torch_vit_to_flax(_subdict(sd, "root."), num_classes=len(son_ids))
    sons = [
        torch_vit_to_flax(_subdict(sd, f"sons.{i}."), num_classes,
                          head_init_seed=i)
        for i in son_ids
    ]
    return {"root": root, "sons": _stack_trees(sons)}


def _normalize_ckpt(path):
    """Reference ``.pth`` path (or an already-loaded object) -> bare state
    dict. Tolerates the tuple checkpoints ``(model_sd, optim[, sched])`` and
    dict formats the reference loaders accept
    (``TIC/utils/serve.py:71-77``)."""
    if isinstance(path, (str, bytes)) or hasattr(path, "__fspath__"):
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    else:
        ckpt = path
    if isinstance(ckpt, tuple):
        ckpt = ckpt[0]
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    if isinstance(ckpt, dict) and "model" in ckpt and all(
        hasattr(v, "shape") for v in ckpt["model"].values()
    ):
        ckpt = ckpt["model"]
    return ckpt


def _dense(tree: Mapping[str, Any]) -> tuple[np.ndarray, np.ndarray]:
    """Dense (in, out) kernel -> nn.Linear (out, in) weight, plus bias."""
    return np.asarray(tree["kernel"]).T, np.asarray(tree["bias"])


def _norm(tree: Mapping[str, Any]) -> tuple[np.ndarray, np.ndarray]:
    return np.asarray(tree["scale"]), np.asarray(tree["bias"])


def from_jax_params(params, cfg: ViTConfig | ResNetConfig | MoEConfig
                    | TreeViTConfig) -> dict[str, torch.Tensor]:
    """JAX ``ViT``, ``ResNet``, ``MoEClassifier`` or ``TreeViT`` variables
    -> state dict of the port's model of ``cfg``.

    A ViT's tree is taken with or without its ``{"params": ...}`` wrapper;
    raises if its depth disagrees with ``cfg.num_layers``. A ResNet's is
    ``(params, {"batch_stats": ...})`` or ``{"params": ..., "batch_stats":
    ...}`` (see :func:`_resnet_from_jax`). A mixture's members go through
    the ViT mapping (see :func:`_members_from_jax`)."""
    if isinstance(cfg, ResNetConfig):
        return _resnet_from_jax(params, cfg)
    if isinstance(cfg, (MoEConfig, TreeViTConfig)):
        return _members_from_jax(params, cfg)
    params = params.get("params", params)
    depth = sum(k.startswith("layer_") for k in params)
    if depth != cfg.num_layers:
        raise ValueError(f"parameter tree has {depth} encoder layers, the "
                         f"config {cfg.num_layers}")
    pairs: dict[str, tuple[np.ndarray, np.ndarray]] = {
        "patch_embed.proj": _dense(params["patch_embed"]["proj"]),
        "final_ln": _norm(params["final_ln"]),
        "head": _dense(params["head"]),
    }
    for i in range(depth):
        layer = params[f"layer_{i}"]
        pairs.update({
            f"layer.{i}.ln1": _norm(layer["ln1"]),
            f"layer.{i}.attn.qkv": _dense(layer["attn"]["qkv"]),
            f"layer.{i}.attn.out": _dense(layer["attn"]["out"]),
            f"layer.{i}.ln2": _norm(layer["ln2"]),
            f"layer.{i}.mlp.fc1": _dense(layer["mlp"]["fc1"]),
            f"layer.{i}.mlp.fc2": _dense(layer["mlp"]["fc2"]),
        })
    sd = {"cls_token": np.asarray(params["cls_token"]),
          "pos_embed": np.asarray(params["pos_embed"])}
    for name, (weight, bias) in pairs.items():
        sd[f"{name}.weight"], sd[f"{name}.bias"] = weight, bias
    return {k: torch.tensor(v, dtype=torch.float32) for k, v in sd.items()}


def _members_from_jax(params, cfg: MoEConfig | TreeViTConfig
                      ) -> dict[str, torch.Tensor]:
    """A ResMoE (``gate/vit`` + stacked ``experts``) or TreeViT (``root`` +
    stacked ``sons``) tree -> the state dict of ``gate.vit.*`` +
    ``experts.{i}.*`` or ``root.*`` + ``sons.{i}.*``. Raises if the stacked
    axis disagrees with the config's member count."""
    from ..models import member_vit_config

    params = params.get("params", params)
    member = member_vit_config(cfg)
    if isinstance(cfg, MoEConfig):
        first = ("gate.vit", params["gate"]["vit"], cfg.num_experts)
        stacked, name, count = params["experts"], "experts", cfg.num_experts
    else:
        first = ("root", params["root"], cfg.num_categories)
        stacked, name, count = params["sons"], "sons", cfg.num_categories
    found = np.asarray(stacked["cls_token"]).shape[0]
    if found != count:
        raise ValueError(f"parameter tree has {found} {name}, the config "
                         f"{count}")
    parts = [first] + [(f"{name}.{i}", _index_tree(stacked, i),
                        cfg.num_classes) for i in range(count)]
    sd = {}
    for prefix, tree, classes in parts:
        vit_cfg = dataclasses.replace(member, num_classes=classes)
        sd.update({f"{prefix}.{k}": v
                   for k, v in from_jax_params(tree, vit_cfg).items()})
    return sd


def _resnet_from_jax(variables, cfg: ResNetConfig) -> dict[str, torch.Tensor]:
    """JAX ``ResNet`` parameters and ``batch_stats`` -> state dict of the
    port's ``ResNet(cfg)``: HWIO conv kernels to OIHW, the head's kernel
    transposed, BN ``scale``/``bias`` to ``weight``/``bias`` and
    ``mean``/``var`` to ``running_mean``/``running_var``. Raises if the
    tree's blocks disagree with ``cfg.depth``."""
    from ..models.resnet import _LAYOUTS

    if isinstance(variables, tuple):
        params, state = variables
    else:
        params, state = variables["params"], variables
    params = params.get("params", params)
    stats = state.get("batch_stats", state)
    block_cls, stages = _LAYOUTS[cfg.depth]
    n_convs = 2 if block_cls.expansion == 1 else 3
    found = [sum(k.startswith(f"stage{s + 1}_block") for k in params)
             for s in range(4)]
    if tuple(found) != tuple(stages):
        raise ValueError(f"parameter tree has {found} blocks a stage, "
                         f"ResNet-{cfg.depth} {list(stages)}")
    sd: dict[str, np.ndarray] = {}

    def conv(dst: str, tree) -> None:
        sd[f"{dst}.weight"] = np.asarray(tree["kernel"]).transpose(3, 2, 0, 1)

    def bn(dst: str, p, s) -> None:
        sd[f"{dst}.weight"], sd[f"{dst}.bias"] = _norm(p)
        sd[f"{dst}.running_mean"] = np.asarray(s["mean"])
        sd[f"{dst}.running_var"] = np.asarray(s["var"])

    conv("conv1", params["stem_conv"])
    bn("bn1", params["stem_bn"], stats["stem_bn"])
    for s, blocks in enumerate(stages, start=1):
        for b in range(blocks):
            src, dst = f"stage{s}_block{b}", f"layer{s}.{b}"
            p, st = params[src], stats[src]
            for j in range(1, n_convs + 1):
                conv(f"{dst}.conv{j}", p[f"conv{j}"])
                bn(f"{dst}.bn{j}", p[f"bn{j}"], st[f"bn{j}"])
            if "downsample_conv" in p:
                conv(f"{dst}.downsample.0", p["downsample_conv"])
                bn(f"{dst}.downsample.1", p["downsample_bn"],
                   st["downsample_bn"])
    sd["fc.weight"], sd["fc.bias"] = _dense(params["head"])
    return {k: torch.tensor(np.ascontiguousarray(v), dtype=torch.float32)
            for k, v in sd.items()}


def read_checkpoint(path: str) -> Mapping[str, Any]:
    """The state dict of a reference ``.pth``/``.pt``/``.bin`` or a
    ``.safetensors`` file."""
    if path.endswith(".safetensors"):
        return _load_state_dict(path)
    return _normalize_ckpt(path)


def convert_checkpoint(state_dict: Mapping[str, Any], cfg
                       ) -> dict[str, torch.Tensor]:
    """A reference or HF/torchvision state dict as a state dict of the
    port's model of ``cfg`` (ViT, ResNet, ResMoE or TreeViT; a mixture's
    member count must be the checkpoint's, see :func:`member_overrides`)."""
    if isinstance(cfg, ResNetConfig):
        tree = torch_resnet_to_flax(state_dict, cfg.num_classes)
    elif isinstance(cfg, MoEConfig):
        tree = torch_moe_to_flax(state_dict, cfg.num_classes)
    elif isinstance(cfg, TreeViTConfig):
        tree = torch_treevit_to_flax(state_dict, cfg.num_classes)
    else:
        tree = torch_vit_to_flax(state_dict, cfg.num_classes)
    return from_jax_params(tree, cfg)


def load_vit_weights(path: str, cfg: ViTConfig) -> dict[str, torch.Tensor]:
    """HF-layout ViT checkpoint at ``path`` -> state dict of ``ViT(cfg)``,
    with a fresh head when the checkpoint's has another class count."""
    return convert_checkpoint(read_checkpoint(path), cfg)


def load_resnet_weights(path: str, cfg: ResNetConfig
                        ) -> dict[str, torch.Tensor]:
    """Reference or torchvision ResNet checkpoint at ``path`` -> state dict
    of ``ResNet(cfg)``, with the head drawn as the JAX package draws it
    (``np.random.default_rng(0)``, normal(0, 0.02), zero bias) when ``fc``
    has another class count."""
    return convert_checkpoint(read_checkpoint(path), cfg)


def convert_and_save(path: str, model_type: str, num_classes: int,
                     out_dir: str) -> str:
    """A reference checkpoint (``.pth``/``.pt``/``.bin`` in the reference's
    bare, tuple or Lightning formats, or ``.safetensors``) -> the state dict
    of the port's ``model_type`` with ``num_classes`` classes, written as
    ``<out_dir>/params.safetensors`` in f32 as converted. A mixture is built
    with the checkpoint's member count (:func:`member_overrides`), and the
    converted state dict must load into the model, every key and shape. No
    ``serving_meta.json`` is written: serve takes the class map and the
    mean and std from its dataset."""
    from ..models import create_model
    from ..train.checkpoint import SERVING_PARAMS, save_params

    state_dict = read_checkpoint(path)
    model = create_model(model_type, num_classes=num_classes, device="cpu",
                         **member_overrides(state_dict, model_type))
    params = convert_checkpoint(state_dict, model.cfg)
    model.load_state_dict(params)
    os.makedirs(out_dir, exist_ok=True)
    save_params(os.path.join(out_dir, SERVING_PARAMS), params)
    return out_dir


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(
        description="Convert torch checkpoints to serving params")
    parser.add_argument("--input", required=True, help=".pth checkpoint path")
    parser.add_argument("--model", required=True,
                        help="model type (vit-large, resnet152, ...)")
    parser.add_argument("--num-classes", type=int, default=120)
    parser.add_argument("--output", required=True,
                        help="output params directory")
    args = parser.parse_args(argv)
    convert_and_save(args.input, args.model, args.num_classes, args.output)
    print(f"Saved converted params to {args.output}")


if __name__ == "__main__":
    main()
