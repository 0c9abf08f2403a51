"""File + console logging per run (the port's copy of the JAX package's
``utils/logging.py``): a named logger writing to ``<log_dir>/<name>.log``
and stdout with the reference's format (``TIC/ViT/finetune.py:21-52``).
One process, so no per-process file suffix."""
from __future__ import annotations

import logging
import os
import sys


def get_logger(name: str, log_dir: str = "log") -> logging.Logger:
    os.makedirs(log_dir, exist_ok=True)
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    if not logger.handlers:
        fh = logging.FileHandler(os.path.join(log_dir, f"{name}.log"))
        ch = logging.StreamHandler(sys.stdout)
        fmt = logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
        for h in (fh, ch):
            h.setLevel(logging.INFO)
            h.setFormatter(fmt)
            logger.addHandler(h)
    return logger
