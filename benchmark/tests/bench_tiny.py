"""Tiny cells that drive the benchmark's traffic drivers on the CPU."""
from __future__ import annotations

import copy
from pathlib import Path

TINY_CONFIG = {
    "name": "tiny", "hidden_size": 64, "num_hidden_layers": 2,
    "num_attention_heads": 2, "intermediate_size": 128,
    "hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0,
    "layer_norm_eps": 1e-12, "image_size": 32, "patch_size": 8,
    "num_channels": 3,
    "port": {"num_labels": 120, "attention_impl": "fused",
             "patch_embed_impl": "xla", "gelu": "fast", "remat": False,
             "compute_dtype": "float32", "train_param_dtype": "float32",
             "serve_param_dtype": "float32"},
}
TINY_PARAMS = {
    "train_step": {"preset": "nvit", "batch": 4, "canvas": 40,
                   "pool_batches": 4, "check_steps": 3, "trace_steps": 2,
                   "ref_block": 2, "rate_metric": "train_img_per_s"},
    "judge_sweep": {"images": 24, "side_min": 40, "side_max": 96,
                    "quality": 90, "batch": 8, "canvas_cache": "on",
                    "check_images": 16, "trace_seconds": 1},
    "web_open_loop": {"rate_per_s": 20, "single_share": 0.8, "multi_min": 2,
                      "multi_max": 8, "pool_images": 8, "side_min": 40,
                      "side_max": 96, "clients": 8, "check_images": 16,
                      "wait_s": 20, "schedule_seed": 1,
                      "warm_seconds": 0.5},
}
TINY_LIMITS = {
    "train_step": {"loss_rel_gap": 1e-4, "grad1_leaf_gap": 1e-3,
                   "change_leaf_gap": 1e-3},
    "judge_sweep": {"logit_gap": 1e-4, "confidence_gap": 1e-3},
    "web_open_loop": {"logit_gap": 1e-4, "confidence_gap": 1e-3},
}


def tiny_context(driver: str, tmp_path: Path, seed: int = 1234567890123,
                 seconds: float = 1.0, config: dict | None = None):
    """A harness context of a tiny cell of ``driver`` on the CPU, in float32
    (the limits above hold float32 against the float32 reference)."""
    import torch

    import harness
    cell = harness.Cell(
        name=f"tiny-{driver}", chips=1,
        config=copy.deepcopy(config or TINY_CONFIG),
        workload={"config": "tiny", "traffic": "tiny", "driver": driver,
                  "params": dict(TINY_PARAMS[driver]),
                  "limits": dict(TINY_LIMITS[driver])},
        end_to_end=[], per_layer=[])
    scratch = tmp_path / "scratch"
    scratch.mkdir(exist_ok=True)
    return harness.Context(cell=cell, seed=seed, seconds=seconds, trace=False,
                           device=torch.device("cpu"), t_process=0.0,
                           scratch=scratch)
