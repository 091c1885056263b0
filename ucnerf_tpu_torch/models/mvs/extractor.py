"""CER-MVS feature encoder (port of ``ucnerf_tpu/models/mvs/extractor.py``).

Functional parity with the reference's ``BasicEncoder``
(``mvs/core/extractor.py:62-150``): a 7x7 stride-2 stem, two residual stages
(instance-norm or no-norm variants), an optional third stage for the 1/8-res
"LR" mode, and a 1x1 projection head.  The convolutions are ``nn.Conv2d``
(NCHW); ``BasicEncoder`` takes and returns the JAX package's NHWC layout.
Submodules carry the flax names, so ``convert`` maps the two parameter trees
name for name.
"""

from __future__ import annotations

import math

import torch
from torch import nn
import torch.nn.functional as F


def conv2d(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    """A k x k conv with flax's ``padding=k // 2``."""
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2)


def init_convs(module: nn.Module, seed: int) -> None:
    """Draw every conv of `module` as the JAX package initialises them,
    from a CPU generator seeded with `seed`: kernels truncated-normal with
    variance scaling 2.0 on fan-out (``variance_scaling(2.0, "fan_out",
    "truncated_normal")``: cut at two standard deviations and rescaled to
    keep the variance), zero biases."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                kh, kw = m.kernel_size
                # 0.8796... is the std of a unit normal cut to [-2, 2].
                std = (math.sqrt(2.0 / (kh * kw * m.out_channels))
                       / 0.87962566103423978)
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std,
                                      b=2 * std, generator=gen)
                m.bias.zero_()


class InstanceNorm(nn.Module):
    """InstanceNorm2d (affine=False): normalise over H, W per channel per
    sample, with the biased variance."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x):  # [N, C, H, W]
        mean = x.mean(dim=(2, 3), keepdim=True)
        var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
        return (x - mean) / torch.sqrt(var + self.eps)


def _norm(norm_fn: str) -> nn.Module:
    if norm_fn == "instance":
        return InstanceNorm()
    if norm_fn == "none":
        return nn.Identity()
    raise NotImplementedError(norm_fn)


class ResidualBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, norm_fn: str = "instance",
                 stride: int = 1):
        super().__init__()
        self.conv1 = conv2d(in_planes, planes, 3, stride)
        self.conv2 = conv2d(planes, planes, 3)
        self.norm = _norm(norm_fn)
        if stride != 1 or in_planes != planes:
            self.downsample = conv2d(in_planes, planes, 1, stride)
        else:
            self.downsample = None

    def forward(self, x):
        y = F.relu(self.norm(self.conv1(x)))
        y = F.relu(self.norm(self.conv2(y)))
        if self.downsample is not None:
            x = self.norm(self.downsample(x))
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """Image -> 1/4-res ("HR") or 1/8-res ("LR") feature map."""

    def __init__(self, output_dim: int = 64, norm_fn: str = "instance",
                 encoder_type: str = "HR", base_dim: int = 32, seed: int = 0):
        super().__init__()
        d = base_dim
        self.conv1 = conv2d(3, d, 7, 2)
        self.norm = _norm(norm_fn)
        self.layer1_0 = ResidualBlock(d, d, norm_fn, 1)
        self.layer1_1 = ResidualBlock(d, d, norm_fn, 1)
        self.layer2_0 = ResidualBlock(d, 2 * d, norm_fn, 2)
        self.layer2_1 = ResidualBlock(2 * d, 2 * d, norm_fn, 1)
        blocks = ["layer1_0", "layer1_1", "layer2_0", "layer2_1"]
        last = 2 * d
        if encoder_type == "LR":
            self.layer3_0 = ResidualBlock(2 * d, 4 * d, norm_fn, 2)
            self.layer3_1 = ResidualBlock(4 * d, 4 * d, norm_fn, 1)
            blocks += ["layer3_0", "layer3_1"]
            last = 4 * d
        self.blocks = blocks
        self.conv2 = conv2d(last, output_dim, 1)
        init_convs(self, seed)

    def forward(self, x):  # [N, H, W, 3] in [-1, 1] -> [N, h, w, C]
        x = F.relu(self.norm(self.conv1(x.permute(0, 3, 1, 2))))
        for name in self.blocks:
            x = getattr(self, name)(x)
        return self.conv2(x).permute(0, 2, 3, 1)
