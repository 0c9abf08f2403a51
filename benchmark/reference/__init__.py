"""The plain reference: the ViT, its preprocessing, its augmentation recipe
and its training step in plain float32 PyTorch. It imports nothing of the
program."""
