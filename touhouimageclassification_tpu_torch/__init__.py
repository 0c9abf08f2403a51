"""PyTorch + CUDA port of the TouhouIC framework for NVIDIA Hopper GPUs.

The JAX package ``touhouimageclassification_tpu`` beside it is the reference
this port is held against. The port imports nothing of it and never JAX: it
keeps its own copies of the numpy modules it needs (config, ImageFolder
indexing, JPEG decode, canvas cache, dataset statistics and the HF
checkpoint readers), which ``tests/test_torch_copies.py`` holds equal.

Subpackages
-----------
- ``config``  the configs and presets (a copy of the JAX package's)
- ``data``    ImageFolder scan, split, JPEG decode, the host batch loader and
  the decoded-canvas cache
- ``device``  explicit device resolution (no quiet CPU fallback)
- ``ops``     attention in its slab, three-operand and (B, N, H, D) forms
  and the patch embedding (hand-written CUDA kernels + plain versions),
  GELU, augmentation, CutMix/MixUp, the kernel build
- ``models``  the ViT and ResNet families
- ``utils``   weight conversion from the JAX parameter tree and from HF and
  torchvision checkpoints; the stdlib WSGI kit of the web demo
- ``train``   losses, optimizer, the NaN-guarded train step, evaluation, the
  epoch loop, checkpoints and the training CLIs
- ``infer``   serving: Predictor, single-image serve, dataset judge CLI, and
  the judge-driven dataset filter
- ``analysis`` the accuracy sweep over the pinned table of serving exports
- ``web``     the web demo: the model daemon and its WSGI app
- ``tools``   kernel measurements on a GPU (the K1/K2 A/B between checkouts)
"""
