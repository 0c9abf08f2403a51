"""ResNet family, 18 to 152 (counterpart of the JAX package's
``models/resnet.py``).

Same architecture and numerics as the JAX ``ResNet``, in torchvision's key
layout (``conv1``, ``bn1``, ``layerS.B.convJ`` / ``bnJ``,
``layerS.B.downsample.0`` / ``.1``, ``fc``), so that a reference or
torchvision state dict loads by key (``utils/convert.py``):

- ``forward`` takes the NHWC images serve and the trainer hand every model;
  their NCHW view is ``channels_last`` in memory, and so are the conv
  weights, so cuDNN runs every convolution in NHWC on the card;
- the convolutions are computed in ``compute_dtype`` over ``param_dtype``
  weights (flax's ``nn.Conv(dtype=..., param_dtype=float32)``). The JAX
  model pads them ``'SAME'`` as ``lax.padtype_to_pads`` does: a 3x3 stride-2
  conv on an even input pads (0, 1), not torch's (1, 1), so an asymmetric
  padding is applied with ``F.pad`` before a conv with none. The stem
  (7x7, 3 each side) and the max pool (1 each side, -inf) are symmetric;
- :class:`BatchNorm2d` is flax's ``nn.BatchNorm(momentum=0.9,
  epsilon=1e-5)``: f32 scale, bias and statistics, the normalisation in
  f32 with one rounding to the compute dtype, and the running statistics
  folded with the biased batch variance;
- the global average pool sums in f32 and rounds to the compute dtype, as
  ``jnp.mean`` of a bf16 array does, before the f32 head.

A new model holds flax's initialisation of the JAX model, drawn from a
``torch.Generator`` on the parameters' device seeded with ``seed``: every
conv kernel from ``variance_scaling(2.0, 'fan_out', 'normal')`` (a plain
normal of standard deviation sqrt(2 / (kh kw out))), the head by
``lecun_normal`` with a zero bias, BN scales one (zero on the last BN of
each residual branch with ``zero_init_residual``), BN biases zero, running
means zero and variances one. The JAX package draws from ``jax.random``, so
the two agree in distribution, not bit for bit.

The ResNet path reaches no Pallas kernel in the JAX package (its convs,
BatchNorm and pooling are XLA ops), and none here: the convs are
``F.conv2d`` (cuDNN); BatchNorm normalises with ATen's
``native_batch_norm`` and its backward, from moments computed here.
"""
from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ResNetConfig
from .vit import _DTYPES, _TRUNCATED_STD, _truncated_normal_

BN_VARIANTS = ("flax",)


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """``lax.padtype_to_pads`` for ``'SAME'`` along one axis: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv2d(nn.Conv2d):
    """flax's ``nn.Conv(use_bias=False)``: weight in ``param_dtype``,
    computed in ``dtype``, padded ``'SAME'`` unless ``padding`` is given
    (symmetric, per side)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int, dtype: torch.dtype, param_dtype: torch.dtype,
                 device=None, padding: int | None = None):
        super().__init__(in_channels, out_channels, kernel, stride=stride,
                         bias=False, device=device, dtype=param_dtype)
        self.compute_dtype = dtype
        self.explicit_padding = padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight = self.weight.to(self.compute_dtype)
        if self.explicit_padding is not None:
            return F.conv2d(x, weight, None, self.stride,
                            self.explicit_padding)
        k, s = self.kernel_size[0], self.stride[0]
        (top, bottom), (left, right) = (same_pads(n, k, s)
                                        for n in x.shape[2:])
        if top == bottom and left == right:
            return F.conv2d(x, weight, None, s, (top, left))
        return F.conv2d(F.pad(x, (left, right, top, bottom)), weight, None, s)


class _BatchNormTrain(torch.autograd.Function):
    """Train-mode BatchNorm over dims (0, 2, 3) with flax's batch moments:
    E[x] and E[x^2] - E[x]^2 (clipped at 0), summed in f32 from the input
    dtype. The forward returns (y, mean, var); the gradient is that of y
    through the batch statistics (ATen's training-mode BatchNorm backward
    on the same mean and 1/sqrt(var + eps))."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps: float):
        dims = (0, 2, 3)
        n = x.numel() // x.shape[1]
        mean = x.mean(dims, dtype=torch.float32)
        mean_sq = torch.linalg.vector_norm(
            x, 2, dims, dtype=torch.float32).square_().div_(n)
        var = mean_sq.sub_(mean.square()).clamp_(min=0)
        y = torch.native_batch_norm(x, weight, bias, mean, var, False, 0.0,
                                    eps)[0]
        ctx.save_for_backward(x, weight, mean, (var + eps).rsqrt())
        ctx.eps = eps
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, grad, _mean, _var):
        x, weight, mean, invstd = ctx.saved_tensors
        gx, gw, gb = torch.ops.aten.native_batch_norm_backward(
            grad, x, weight, None, None, mean, invstd, True, ctx.eps,
            [True, True, True])
        return gx, gw, gb, None


class BatchNorm2d(nn.Module):
    """flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=<compute>,
    param_dtype=float32)`` over the channels of an (N, C, H, W) tensor.

    Output: ``(x - mean) * rsqrt(var + eps) * scale + bias`` in f32,
    rounded once to the input dtype. In ``train()`` mode mean and var are
    the batch's, computed as flax computes them (``use_fast_variance``:
    E[x] and E[x^2] - E[x]^2 in f32), the variance biased (divided by
    N H W); the running statistics then become ``0.9 * running + 0.1 *
    batch`` with that same biased variance (torch's ``BatchNorm2d`` folds
    the unbiased one and calls its rate 0.1). In ``eval()`` mode the running
    statistics normalise. There is no ``num_batches_tracked`` buffer; the
    loaders drop a torchvision one.
    """

    momentum = 0.9   # flax's: the share of the old statistic kept
    eps = 1e-5

    def __init__(self, features: int, device=None):
        super().__init__()
        f32 = dict(dtype=torch.float32, device=device)
        self.weight = nn.Parameter(torch.ones(features, **f32))
        self.bias = nn.Parameter(torch.zeros(features, **f32))
        self.register_buffer("running_mean", torch.zeros(features, **f32))
        self.register_buffer("running_var", torch.ones(features, **f32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        y, mean, var = _BatchNormTrain.apply(x, self.weight, self.bias,
                                             self.eps)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(m).add_(mean, alpha=1 - m)
            self.running_var.mul_(m).add_(var, alpha=1 - m)
        return y


class BasicBlock(nn.Module):
    expansion = 1
    last_bn = "bn2"   # the last BN of the residual branch

    def __init__(self, in_channels: int, filters: int, stride: int,
                 conv, norm):
        super().__init__()
        self.conv1 = conv(in_channels, filters, 3, stride)
        self.bn1 = norm(filters)
        self.conv2 = conv(filters, filters, 3, 1)
        self.bn2 = norm(filters)
        self.downsample = None
        if stride != 1 or in_channels != filters:
            self.downsample = nn.Sequential(
                conv(in_channels, filters, 1, stride), norm(filters))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)), inplace=True)
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y.add_(residual), inplace=True)


class Bottleneck(nn.Module):
    expansion = 4
    last_bn = "bn3"

    def __init__(self, in_channels: int, filters: int, stride: int,
                 conv, norm):
        super().__init__()
        out = filters * 4
        self.conv1 = conv(in_channels, filters, 1, 1)
        self.bn1 = norm(filters)
        self.conv2 = conv(filters, filters, 3, stride)
        self.bn2 = norm(filters)
        self.conv3 = conv(filters, out, 1, 1)
        self.bn3 = norm(out)
        self.downsample = None
        if stride != 1 or in_channels != out:
            self.downsample = nn.Sequential(conv(in_channels, out, 1, stride),
                                            norm(out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)), inplace=True)
        y = F.relu(self.bn2(self.conv2(y)), inplace=True)
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y.add_(residual), inplace=True)


_LAYOUTS: dict[int, tuple[type, tuple[int, ...]]] = {
    18: (BasicBlock, (2, 2, 2, 2)),
    34: (BasicBlock, (3, 4, 6, 3)),
    50: (Bottleneck, (3, 4, 6, 3)),
    101: (Bottleneck, (3, 4, 23, 3)),
    152: (Bottleneck, (3, 8, 36, 3)),
}


class ResNet(nn.Module):
    """ResNet classifier: ``forward`` maps (B, H, W, 3) NHWC images to
    (B, num_classes) f32 logits. ``param_dtype`` (default:
    ``compute_dtype``) is the storage type of the conv weights; BatchNorm
    and the head keep f32. ``seed`` seeds the initialisation
    (:meth:`reset_parameters`)."""

    def __init__(self, cfg: ResNetConfig, compute_dtype: str = "bfloat16",
                 device=None, param_dtype: str | None = None, seed: int = 0):
        super().__init__()
        param_dtype = param_dtype or compute_dtype
        for name, value in (("compute_dtype", compute_dtype),
                            ("param_dtype", param_dtype)):
            if value not in _DTYPES:
                raise ValueError(f"{name} must be one of {tuple(_DTYPES)}, "
                                 f"got {value!r}")
        if cfg.bn_variant not in BN_VARIANTS:
            raise NotImplementedError(
                f"bn_variant={cfg.bn_variant!r} is not ported (ROADMAP.md "
                "'Not ported'); use 'flax'")
        if cfg.depth not in _LAYOUTS:
            raise ValueError(f"ResNet depth {cfg.depth} not in "
                             f"{sorted(_LAYOUTS)}")
        self.cfg = cfg
        self.dtype = dtype = _DTYPES[compute_dtype]
        conv = partial(Conv2d, dtype=dtype, param_dtype=_DTYPES[param_dtype],
                       device=device)
        norm = partial(BatchNorm2d, device=device)
        block_cls, stages = _LAYOUTS[cfg.depth]
        self.conv1 = conv(3, 64, 7, 2, padding=3)
        self.bn1 = norm(64)
        channels = 64
        for stage, num_blocks in enumerate(stages):
            filters = 64 * 2 ** stage
            blocks = []
            for block in range(num_blocks):
                stride = 2 if stage > 0 and block == 0 else 1
                blocks.append(block_cls(channels, filters, stride, conv, norm))
                channels = filters * block_cls.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.fc = nn.Linear(channels, cfg.num_classes, dtype=torch.float32,
                            device=device)
        self.to(memory_format=torch.channels_last)
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        """flax's initialisation of the JAX model (module docstring), drawn
        in module order from a generator seeded with ``seed``."""
        gen = torch.Generator(device=self.fc.weight.device).manual_seed(seed)
        for module in self.modules():
            if isinstance(module, Conv2d):
                out, _, kh, kw = module.weight.shape
                std = math.sqrt(2.0 / (kh * kw * out))
                module.weight.copy_(std * torch.randn(
                    module.weight.shape, generator=gen,
                    device=module.weight.device))
            elif isinstance(module, BatchNorm2d):
                nn.init.ones_(module.weight)
                nn.init.zeros_(module.bias)
                module.running_mean.zero_()
                module.running_var.fill_(1.0)
        if self.cfg.zero_init_residual:
            for module in self.modules():
                if isinstance(module, (BasicBlock, Bottleneck)):
                    nn.init.zeros_(getattr(module, module.last_bn).weight)
        _truncated_normal_(self.fc.weight,
                           self.fc.in_features ** -0.5 / _TRUNCATED_STD, gen)
        nn.init.zeros_(self.fc.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = F.relu(self.bn1(self.conv1(x)), inplace=True)
        x = F.max_pool2d(x, 3, 2, 1)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        x = x.float().mean((2, 3)).to(self.dtype)
        return self.fc(x.float())


def resnet(depth: int, num_classes: int = 120, compute_dtype: str = "bfloat16",
           device=None, param_dtype: str | None = None, seed: int = 0,
           **overrides) -> ResNet:
    """Depth factories mirroring ``resnet18/34/50/101/152``."""
    return ResNet(ResNetConfig(depth=depth, num_classes=num_classes,
                               **overrides),
                  compute_dtype=compute_dtype, device=device,
                  param_dtype=param_dtype, seed=seed)


resnet18 = partial(resnet, 18)
resnet34 = partial(resnet, 34)
resnet50 = partial(resnet, 50)
resnet101 = partial(resnet, 101)
resnet152 = partial(resnet, 152)
