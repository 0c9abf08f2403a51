"""Weight conversion for the port's ViT and ResNet.

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
  package draws it (``ignore_mismatched_sizes``). :func:`load_weights`
  picks the loader by the model's config.

``_strip_prefixes``, ``torch_vit_to_flax``, ``torch_resnet_to_flax`` and
``_normalize_ckpt`` are the port's copies of the JAX package's
(``utils/convert.py``), with the same names and results
(``tests/test_torch_copies.py``).
"""
from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

from ..config import ResNetConfig, ViTConfig
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


def from_jax_params(params, cfg: ViTConfig | ResNetConfig
                    ) -> dict[str, torch.Tensor]:
    """JAX ``ViT`` or ``ResNet`` variables -> state dict of the port's
    model of ``cfg``.

    A ViT's tree is taken with or without its ``{"params": ...}`` wrapper;
    raises if its depth disagrees with ``cfg.num_layers``. A ResNet's is
    ``(params, {"batch_stats": ...})`` or ``{"params": ..., "batch_stats":
    ...}`` (see :func:`_resnet_from_jax`)."""
    if isinstance(cfg, ResNetConfig):
        return _resnet_from_jax(params, cfg)
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


def _read_ckpt(path: str):
    if path.endswith(".safetensors"):
        return _load_state_dict(path)
    return _normalize_ckpt(path)


def load_vit_weights(path: str, cfg: ViTConfig) -> dict[str, torch.Tensor]:
    """HF-layout ViT checkpoint at ``path`` -> state dict of ``ViT(cfg)``,
    with a fresh head when the checkpoint's has another class count."""
    return from_jax_params(torch_vit_to_flax(_read_ckpt(path),
                                             cfg.num_classes), cfg)


def load_resnet_weights(path: str, cfg: ResNetConfig
                        ) -> dict[str, torch.Tensor]:
    """Reference or torchvision ResNet checkpoint at ``path`` -> state dict
    of ``ResNet(cfg)``, with the head drawn as the JAX package draws it
    (``np.random.default_rng(0)``, normal(0, 0.02), zero bias) when ``fc``
    has another class count."""
    return from_jax_params(torch_resnet_to_flax(_read_ckpt(path),
                                                cfg.num_classes), cfg)


def load_weights(path: str, cfg: ViTConfig | ResNetConfig
                 ) -> dict[str, torch.Tensor]:
    """The checkpoint at ``path`` as a state dict of the model of ``cfg``
    (:func:`load_resnet_weights` or :func:`load_vit_weights`)."""
    if isinstance(cfg, ResNetConfig):
        return load_resnet_weights(path, cfg)
    return load_vit_weights(path, cfg)
