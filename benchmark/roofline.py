"""The yardstick's arithmetic: the H100's published peaks and the work of
the ViT forward and of the attention kernels K1 (forward) and K2
(backward), as functions of shape.

Peaks are NVIDIA's data sheet for one H100 SXM at its full 700 W power
limit, dense rates without sparsity. A share of a peak is stated beside
the card's power limit, which the result line carries.
"""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12   # tensor cores, bf16, dense
PEAK_HBM_BYTES = 3.35e12   # HBM3, bytes/s


def vit_forward_flops(hidden: int, layers: int, mlp: int, image: int,
                      patch: int, classes: int) -> float:
    """Multiply-adds times two of one image's ViT forward: the patch
    projection, per layer the QKV, output and two MLP projections and the
    two attention products (Q K^T and P V), and the head. Normalisations,
    softmax and elementwise work are not counted."""
    patches = (image // patch) ** 2
    n = patches + 1
    per_layer = (2 * n * hidden * 3 * hidden      # qkv
                 + 2 * n * hidden * hidden        # out
                 + 2 * 2 * n * hidden * mlp       # fc1, fc2
                 + 2 * 2 * n * n * hidden)        # S = Q K^T, O = P V
    embed = 2 * patches * (patch * patch * 3) * hidden
    head = 2 * hidden * classes
    return float(embed + layers * per_layer + head)


def train_step_flops(forward_flops: float) -> float:
    """One image's forward and backward: three forwards."""
    return 3.0 * forward_flops


def _slab_bytes(tensors: int, batch: int, n: int, hidden: int,
                itemsize: int) -> float:
    return float(tensors * batch * n * hidden * itemsize)


def k1_bytes(batch: int, n: int, hidden: int, itemsize: int = 2) -> float:
    """K1 reads Q, K and V once and writes O once: four (B, N, C) tensors."""
    return _slab_bytes(4, batch, n, hidden, itemsize)


def k2_bytes(batch: int, n: int, hidden: int, itemsize: int = 2) -> float:
    """K2 reads Q, K, V and dO once and writes dQ, dK and dV once: seven
    (B, N, C) tensors (the softmax statistics are recomputed)."""
    return _slab_bytes(7, batch, n, hidden, itemsize)


def bytes_bound_s(nbytes: float) -> float:
    """The least time the card can move ``nbytes`` in."""
    return nbytes / PEAK_HBM_BYTES


def flops_bound_s(flops: float) -> float:
    return flops / PEAK_BF16_FLOPS


def k1_bound_s(batch: int, n: int, hidden: int) -> float:
    """K1's roofline time: its bytes bound it (its FLOPs, 4 B N^2 C, take
    less than a tenth of that time at N 197)."""
    return max(bytes_bound_s(k1_bytes(batch, n, hidden)),
               flops_bound_s(4.0 * batch * n * n * hidden))


def k2_bound_s(batch: int, n: int, hidden: int) -> float:
    """K2's roofline time: its bytes bound it (its FLOPs, 10 B N^2 C with
    the recomputed scores, take less time at N 197)."""
    return max(bytes_bound_s(k2_bytes(batch, n, hidden)),
               flops_bound_s(10.0 * batch * n * n * hidden))
