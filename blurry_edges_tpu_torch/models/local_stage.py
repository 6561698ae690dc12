"""Local-stage CNN: (B, 21, 21, 3) noisy patch -> 10 Blurry-Edges parameters
(x0, y0, x1, y1, theta1, phi1, theta2, phi2, eta-coef1, eta-coef2).

A ResNet-like trunk with the Smish activation, BatchNorm, two 3/2 max-pools
and one 2/2, residual stages of widths 96/256/384/256 and an FC head
3*3*256 -> 1024 -> 10 (~7.2 M parameters). NCHW inside, NHWC at the
interface. Module names follow the reference state dict (``conv1.0``,
``layer{k}.0.conv1.0``, ``fc.1``, ...), so a reference ``.pth`` loads as is.

``dtype=torch.bfloat16`` computes as the JAX package's ``LocalStage(dtype=
jnp.bfloat16)``: every convolution and linear layer casts its input and
parameters to bfloat16 (``models/layers.py``), BatchNorm computes in
float32 and returns bfloat16, and Smish, the residual sums and the pooling
run in bfloat16; the output is bfloat16 and the caller casts it back.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .batchnorm import BatchNorm1d, BatchNorm2d
from .layers import Conv2d, Linear, set_compute_dtype


def smish(x):
    """Smish(x) = x * tanh(log(1 + sigmoid(x))). In bfloat16 the sigmoid is
    1 / (1 + exp(-x)) with each operation rounded, as XLA expands Flax's
    ``nn.sigmoid`` (torch.sigmoid would round once)."""
    if x.dtype != torch.bfloat16:
        return x * torch.tanh(torch.log1p(torch.sigmoid(x)))
    return x * torch.tanh(torch.log1p(1.0 / (1.0 + torch.exp(-x))))


class Smish(nn.Module):
    def forward(self, x):
        return smish(x)


class ResidualBlock(nn.Module):
    """conv3x3+BN, Smish, conv3x3+BN, plus the skip (1x1 conv+BN where the
    width changes), Smish after the sum."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.conv1 = nn.Sequential(Conv2d(in_features, features, 3, padding=1),
                                   BatchNorm2d(features), Smish())
        self.conv2 = nn.Sequential(Conv2d(features, features, 3, padding=1),
                                   BatchNorm2d(features))
        self.downsample = None
        if in_features != features:
            self.downsample = nn.Sequential(Conv2d(in_features, features, 1),
                                            BatchNorm2d(features))

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        return smish(self.conv2(self.conv1(x)) + residual)


class LocalStage(nn.Module):
    """Input (B, R, R, 3) NHWC, output (B, output_dim).

    Spatial plan for R=21: conv7 (21) -> pool3/2 (11) -> stage 96 -> pool3/2
    (6) -> stages 256/384/256 -> pool2/2 (3) -> flatten (C, H, W) -> 1024 ->
    output_dim.
    """

    def __init__(self, widths: Sequence[int] = (96, 256, 384, 256),
                 output_dim: int = 10, dtype=torch.float32):
        super().__init__()
        self.conv1 = nn.Sequential(Conv2d(3, 64, 7, padding=3),
                                   BatchNorm2d(64), Smish())
        ins = (64,) + tuple(widths[:-1])
        for k, (i, o) in enumerate(zip(ins, widths)):
            setattr(self, f"layer{k}", nn.Sequential(ResidualBlock(i, o)))
        self.fc = nn.Sequential(nn.Flatten(), Linear(widths[-1] * 9, 1024),
                                BatchNorm1d(1024), Smish(),
                                Linear(1024, output_dim))
        set_compute_dtype(self, dtype)

    def forward(self, x):
        y = self.conv1(x.permute(0, 3, 1, 2))
        y = F.max_pool2d(y, 3, 2, padding=1)
        y = self.layer0(y)
        y = F.max_pool2d(y, 3, 2, padding=1)
        y = self.layer3(self.layer2(self.layer1(y)))
        y = F.max_pool2d(y, 2, 2)
        return self.fc(y)
