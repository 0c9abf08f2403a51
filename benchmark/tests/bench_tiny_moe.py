"""Tiny cells of the V-MoE and loader drivers on the CPU: V-MoE at hidden
64, 4 layers (MoE in 1 and 3), 8 experts of which 4 held, top-2, two
routing groups of 2 images; the loader over 48 small JPEGs."""
from __future__ import annotations

import copy
from pathlib import Path

from bench_tiny import TINY_CONFIG

TINY_MOE_CONFIG = dict(
    copy.deepcopy(TINY_CONFIG), name="tiny-moe", num_hidden_layers=4,
    moe_layers=[1, 3], num_experts=8, num_selected_experts=2,
    capacity_factor=1.05, router_noise_std=1.0, router_bias=False,
    importance_loss_weight=0.005, load_loss_weight=0.005,
    group_size_images=2, num_experts_held=4)
PARAMS = {
    "train_step_moe": {"preset": "nvit", "batch": 4, "canvas": 40,
                       "pool_batches": 4, "check_steps": 3, "trace_steps": 2,
                       "rate_metric": "train_img_per_s"},
    "train_loader": {"preset": "nvit", "batch": 4, "canvas": 40,
                     "images": 48, "side_min": 40, "side_max": 96,
                     "quality": 90, "check_steps": 3, "trace_steps": 2,
                     "ref_block": 2, "rate_metric": "train_b8_img_per_s"},
}
LIMITS = {
    "train_step_moe": {"loss_rel_gap": 1e-4, "grad1_leaf_gap": 1e-3,
                       "change_leaf_gap": 1e-3, "route_flip_share": 1e-3},
    "train_loader": {"canvas_gap": 1, "loss_rel_gap": 1e-4,
                     "grad1_leaf_gap": 1e-3, "change_leaf_gap": 1e-3},
}


def tiny_cell_context(driver: str, tmp_path: Path,
                      seed: int = 1234567890123, seconds: float = 1.0,
                      trace: bool = False):
    """A harness context of a tiny cell of ``driver`` on the CPU, in
    float32 (the limits hold float32 against the float32 reference)."""
    import torch

    import harness
    config = TINY_MOE_CONFIG if driver == "train_step_moe" else TINY_CONFIG
    cell = harness.Cell(
        name=f"tiny-{driver}", chips=1, config=copy.deepcopy(config),
        workload={"config": "tiny", "traffic": "tiny", "driver": driver,
                  "params": dict(PARAMS[driver]),
                  "limits": dict(LIMITS[driver])},
        end_to_end=[], per_layer=[])
    scratch = tmp_path / "scratch"
    scratch.mkdir(exist_ok=True)
    return harness.Context(cell=cell, seed=seed, seconds=seconds, trace=trace,
                           device=torch.device("cpu"), t_process=0.0,
                           scratch=scratch)
