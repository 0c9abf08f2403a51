"""PyTorch + CUDA port of the TouhouIC framework for NVIDIA Hopper GPUs.

The JAX package ``touhouimageclassification_tpu`` beside it is the reference
this port is held against; the port reuses its numpy-only modules (config,
ImageFolder indexing, JPEG decode, canvas cache, dataset statistics and the
HF checkpoint readers) and never imports JAX.

Subpackages
-----------
- ``config``  the configs and presets (the JAX package's, which import no JAX)
- ``data``    ImageFolder scan, split and the host batch loader
- ``device``  explicit device resolution (no quiet CPU fallback)
- ``ops``     slab attention (hand-written CUDA kernels, forward and
  backward, + plain versions), GELU, augmentation, CutMix/MixUp, the kernel
  build
- ``models``  the ViT family
- ``utils``   weight conversion from the JAX parameter tree and HF checkpoints
- ``train``   losses, optimizer, the NaN-guarded train step and evaluation
- ``infer``   serving: Predictor, single-image serve, dataset judge CLI
"""
