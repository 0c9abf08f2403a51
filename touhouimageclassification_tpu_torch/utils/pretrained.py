"""Pretrained-backbone resolution without network access (counterpart of
the JAX package's ``utils/pretrained.py``).

Replaces the reference's ``ensure()`` (``TIC/utils/ensure.py:11-15``,
which downloads HF snapshots on demand): pretrained weights must already
exist locally, as an HF snapshot directory (safetensors or
``pytorch_model*.bin``) under ``CACHE_DIR``. :func:`load_pretrained_backbone`
returns the port's state dict, or ``None`` with a warning when nothing is
found, and training then starts from the model's seeded scratch
initialisation (the reference's ``pretrained=False`` path). The JAX
package's converted-Orbax branch has no counterpart here.
"""
from __future__ import annotations

import glob
import os
import warnings

import numpy as np
import torch

from ..config import CACHE_DIR, ViTConfig

_HF_NAMES = {
    "vit-base": "google/vit-base-patch16-224-in21k",
    "vit-large": "google/vit-large-patch16-224-in21k",
}


def _load_state_dict(path: str):
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        return load_file(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def _adapt_head(sd: dict[str, torch.Tensor], hidden: int, num_classes: int,
                seed: int = 0) -> dict[str, torch.Tensor]:
    """A head for ``num_classes`` (``ignore_mismatched_sizes``): kept when
    its size matches, else normal(0, 0.02) drawn from numpy seed ``seed``
    (the JAX package's draws, transposed to ``nn.Linear``'s (out, in)) and
    a zero bias."""
    if sd["head.weight"].shape[0] == num_classes:
        return sd
    rng = np.random.default_rng(seed)
    kernel = rng.normal(0.0, 0.02, (hidden, num_classes)).astype(np.float32)
    return {**sd, "head.weight": torch.from_numpy(kernel.T.copy()),
            "head.bias": torch.zeros(num_classes)}


def _snapshot_weights(cand: str) -> list[str]:
    """The whole weight files of an HF snapshot directory, sorted; raises
    when it holds only shards."""
    weights = sorted(
        glob.glob(os.path.join(cand, "**", "*.safetensors"), recursive=True)
        # pytorch_model*.bin: shards (pytorch_model-00001-of-000NN.bin) must
        # be seen so that a shard-only snapshot is refused loudly
        + glob.glob(os.path.join(cand, "**", "pytorch_model*.bin"),
                    recursive=True))
    whole = [w for w in weights if "-of-" not in os.path.basename(w)]
    if weights and not whole:
        raise ValueError(
            f"sharded checkpoint under {cand} ({len(weights)} files); "
            "loading one shard would silently drop weights — merge it first")
    return whole


def load_pretrained_backbone(model_type: str, num_classes: int,
                             cache_dir: str = CACHE_DIR
                             ) -> dict[str, torch.Tensor] | None:
    """Locate and load pretrained ViT weights for ``model_type`` as a state
    dict of the port's ViT, with the classifier head adapted to
    ``num_classes``. Depth and width are the snapshot's (as the JAX
    package's converter infers them); a model of another shape refuses the
    state dict when it loads it."""
    from .convert import from_jax_params, torch_vit_to_flax

    hf_name = _HF_NAMES.get(model_type, model_type)
    safe = hf_name.replace("/", "--")
    candidates = [
        os.path.join(cache_dir, f"models--{safe}"),
        os.path.join(cache_dir, hf_name),
        os.path.join(cache_dir, os.path.basename(hf_name)),
        os.path.join(cache_dir, safe),
    ]
    for cand in candidates:
        if not os.path.isdir(cand):
            continue
        weights = _snapshot_weights(cand)
        if not weights:
            continue
        if len(weights) > 1:
            # hub caches can hold several revisions: the sorted order makes
            # the pick deterministic; say which file won
            warnings.warn(f"{len(weights)} weight files under {cand}; "
                          f"loading {weights[0]}", stacklevel=2)
        tree = torch_vit_to_flax(_load_state_dict(weights[0]), num_classes)
        depth = sum(k.startswith("layer_") for k in tree)
        sd = from_jax_params(tree, ViTConfig(num_layers=depth))
        return _adapt_head(sd, sd["cls_token"].shape[-1], num_classes)

    warnings.warn(
        f"No pretrained weights for {model_type} under {cache_dir}; "
        "training from scratch. Place an HF snapshot in the cache dir.",
        stacklevel=2)
    return None


def ensure(model_name: str, cache_dir: str = CACHE_DIR) -> str:
    """Name-compat shim for the reference's ``ensure``: a local path for the
    model if cached, else raises (downloads are unavailable)."""
    safe = model_name.replace("/", "--")
    for cand in (os.path.join(cache_dir, safe),
                 os.path.join(cache_dir, f"models--{safe}")):
        if os.path.isdir(cand):
            return cand
    raise FileNotFoundError(
        f"{model_name} not cached under {cache_dir} and downloads are "
        "unavailable; place an HF snapshot there")
