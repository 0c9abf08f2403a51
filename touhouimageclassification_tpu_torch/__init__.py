"""PyTorch + CUDA port of the TouhouIC framework for NVIDIA Hopper GPUs.

The JAX package ``touhouimageclassification_tpu`` beside it is the reference
this port is held against; the port reuses its numpy-only modules (config,
ImageFolder indexing, JPEG decode, canvas cache, dataset statistics and the
HF checkpoint readers) and never imports JAX.

Subpackages
-----------
- ``device``  explicit device resolution (no quiet CPU fallback)
- ``ops``     slab attention (hand-written CUDA kernel + plain version),
  GELU, resize/normalize, the kernel build
- ``models``  the ViT family
- ``utils``   weight conversion from the JAX parameter tree and HF checkpoints
- ``infer``   serving: Predictor, single-image serve, dataset judge CLI
"""
