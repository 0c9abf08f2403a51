"""The configuration the port runs from.

The dataclasses, presets and model configs are the JAX package's
``config.py``, which is plain Python and imports no JAX; the port and its
callers take them from here.
"""
from touhouimageclassification_tpu.config import (FILTERED_DATA_DIR,
                                                  NUM_CLASSES, PRESETS,
                                                  AugmentConfig, MixConfig,
                                                  OptimizerConfig, TrainConfig,
                                                  ViTConfig, vit_config)

__all__ = ["FILTERED_DATA_DIR", "NUM_CLASSES", "PRESETS", "AugmentConfig",
           "MixConfig", "OptimizerConfig", "TrainConfig", "ViTConfig",
           "vit_config"]
