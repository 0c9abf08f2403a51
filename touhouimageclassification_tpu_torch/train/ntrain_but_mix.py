"""Ablation launcher: the ``TIC.ViT.ntrain_but_mix`` equivalent, one preset
toggle off the main recipe (counterpart of the JAX package's
``train/ntrain_but_mix.py``)."""
from .ntrain import main

if __name__ == "__main__":
    main(preset="nvit_but_mix")
