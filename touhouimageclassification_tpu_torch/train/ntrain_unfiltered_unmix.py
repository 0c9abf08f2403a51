"""Ablation launcher: the ``TIC.ViT.ntrain_unfiltered_unmix`` equivalent, one preset
toggle off the main recipe (counterpart of the JAX package's
``train/ntrain_unfiltered_unmix.py``)."""
from .ntrain import main

if __name__ == "__main__":
    main(preset="nvit_unfiltered_unmix")
