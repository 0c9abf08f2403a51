"""ViT scratch pretraining (counterpart of the JAX package's
``train/pretrain.py``, the ``TIC.ViT.pretrain`` equivalent).

Reference recipe (``TIC/ViT/pretrain.py:272-340``): the finetune loop with
``USE_PRETRAINED=False`` (the ``pretrain_vit`` preset: the seeded scratch
initialisation), 60 epochs, batch 80, LR 1e-4, early-stop patience 3.
"""
from __future__ import annotations

from .finetune import main as _main


def main(argv=None):
    return _main(argv, preset="pretrain_vit")


if __name__ == "__main__":
    main()
