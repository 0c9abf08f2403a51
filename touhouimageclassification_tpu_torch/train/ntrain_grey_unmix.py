"""Ablation launcher: the ``TIC.ViT.ntrain_grey_unmix`` equivalent, one preset
toggle off the main recipe (counterpart of the JAX package's
``train/ntrain_grey_unmix.py``)."""
from .ntrain import main

if __name__ == "__main__":
    main(preset="nvit_grey_unmix")
