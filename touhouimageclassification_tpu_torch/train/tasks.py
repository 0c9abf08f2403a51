"""The mixture families' training tasks for the port's ``Trainer``
(counterpart of the JAX package's ``train/tasks.py``).

- :class:`MoETask`: the ResMoE objective (``TIC/ResMoE/train.py:21-74``),
  symmetric CE plus the balance penalty, and under sparse routing the
  routing telemetry (``drop_frac``, ``expert_load_max``,
  ``expert_load_min``), which ``Trainer.fit`` averages into each epoch's
  record. The gate's training noise comes from the step's generator.
- :class:`TreeRootTask`, :class:`TreeSonsTask`, :class:`TreeFullTask`: the
  TreeViT staged curriculum (``TIC/TreeViT/train.py:139-179``): the root on
  category labels, the sons teacher-routed to their own categories in
  parallel (teacher-forced only while training: eval measures the root's
  real routing), then the whole tree, with capacity-dropped samples masked
  out of the loss.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import MoEConfig, TreeViTConfig
from ..ops import moe_dispatch as md
from . import losses
from .trainer import ClassificationTask


class MoETask(ClassificationTask):
    def __init__(self, cfg: MoEConfig):
        self.cfg = cfg

    def forward(self, model, images, batch, train, generator=None):
        model.train(train)
        return model(images, generator=generator)

    def loss(self, outputs, soft_labels):
        logits, gate_for_loss, top_i = outputs
        cfg = self.cfg
        cls_loss = losses.symmetric_cross_entropy(logits, soft_labels,
                                                  cfg.sce_alpha, cfg.sce_beta)
        if cfg.balance_loss == "switch":
            bal_loss = losses.switch_load_balance_loss(gate_for_loss, top_i,
                                                       cfg.num_experts)
        else:
            bal_loss = losses.load_balance_loss(gate_for_loss)
        total = cls_loss + cfg.balance_loss_alpha * bal_loss
        aux = {"classification_loss": cls_loss.detach(),
               "balance_loss": bal_loss.detach()}
        if cfg.routing == "sparse":
            # the share of routed copies past an expert's capacity, and the
            # spread of the experts' shares of the assignments
            b = gate_for_loss.shape[0]
            routed = top_i.reshape(-1)
            counts = torch.zeros(cfg.num_experts,
                                 device=routed.device).index_add_(
                0, routed, torch.ones(routed.shape, device=routed.device))
            capacity = md.capacity_for(b, cfg.top_k, cfg.num_experts,
                                       cfg.capacity_factor)
            load = counts / (b * cfg.top_k)
            aux["drop_frac"] = ((counts - capacity).clamp(min=0.0).sum()
                                / (b * cfg.top_k))
            aux["expert_load_max"] = load.max()
            aux["expert_load_min"] = load.min()
        return total, aux

    def logits(self, outputs):
        return outputs[0]


class _TreeTaskBase(ClassificationTask):
    """The category map (class index -> category index) for relabelling
    and routing."""

    def __init__(self, cfg: TreeViTConfig, class_to_category: np.ndarray):
        self.cfg = cfg
        self._class_to_category = torch.from_numpy(
            np.asarray(class_to_category, np.int64))

    def _map_on(self, device: torch.device) -> torch.Tensor:
        """The class -> category map on ``device`` (copied there once)."""
        if self._class_to_category.device != device:
            self._class_to_category = self._class_to_category.to(device)
        return self._class_to_category

    def categories(self, labels: torch.Tensor) -> torch.Tensor:
        """The category of each class label, on the labels' device."""
        return self._map_on(labels.device)[labels.long()]


class TreeRootTask(_TreeTaskBase):
    """Stage 1: the root learns image -> category (the sons are frozen by
    the stage's ``param_filter``, ``train/treevit.py``)."""

    def loss(self, outputs, soft_labels):
        choice = outputs[1]
        # class one-hots to category one-hots through the 0/1 map
        cats = self._map_on(soft_labels.device)
        cat_map = torch.zeros(cats.numel(), int(self.cfg.num_categories),
                              dtype=soft_labels.dtype,
                              device=soft_labels.device).scatter_(
            1, cats[:, None], 1.0)
        return losses.symmetric_cross_entropy(choice,
                                              soft_labels @ cat_map), {}

    def logits(self, outputs):
        return outputs[1]  # category logits

    def labels(self, batch):
        # eval in category space (the reference's CategoryDataset)
        return self.categories(batch["label"])


class TreeSonsTask(_TreeTaskBase):
    """Stage 2: teacher-forced routing to the true category's son while
    training, so every son trains on its own subset at once; eval routes by
    the root, so the stage's val_loss / val_acc measure inference."""

    def forward(self, model, images, batch, train, generator=None):
        model.train(train)
        route = self.categories(batch["label"]) if train else None
        return model(images, route_labels=route)

    def loss(self, outputs, soft_labels):
        return _tree_combined_loss(outputs, soft_labels)

    def logits(self, outputs):
        return outputs[0]


class TreeFullTask(_TreeTaskBase):
    """Stage 3: end to end on class labels through the root's routing."""

    def loss(self, outputs, soft_labels):
        return _tree_combined_loss(outputs, soft_labels)

    def logits(self, outputs):
        return outputs[0]


def _tree_combined_loss(outputs, soft_labels):
    combined, _choice, kept = outputs
    # a sample whose every routed copy was capacity-dropped carries no
    # signal: masked out of the loss instead of training on zero logits
    w = (kept > 0).float()
    sce = losses.symmetric_cross_entropy(combined, soft_labels,
                                         sample_weights=w)
    return sce, {"dropped_frac": 1.0 - w.mean()}
