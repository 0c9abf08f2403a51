"""The port's web demo: ``python -m
touhouimageclassification_tpu_torch.web.app --device cuda``."""
