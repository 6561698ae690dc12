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

Each convolution (and the head's first linear layer) runs with its tail
(bias, BatchNorm, the residual sum, Smish, the max-pool) through ``tail``:
in float32 on a CUDA card in eval mode with autograd off one kernel a
junction (``ops/local_epilogue.py``), ten a forward; otherwise the modules'
own chain, ``local_epilogue_plain``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.local_epilogue import Smish, fuses, local_epilogue, smish
from ..utils.trace import span
from .batchnorm import BatchNorm1d, BatchNorm2d
from .layers import Conv2d, Linear, set_compute_dtype


def local_epilogue_plain(y, norm, residual=None, residual_norm=None, pool=None):
    """``smish(norm(y) + residual_norm(residual))``, then ``F.max_pool2d(.,
    *pool)``: the tail as the modules compute it on their layers' outputs,
    and the oracle of the ``local_epilogue`` kernel. ``residual`` None: no
    sum; ``residual_norm`` None: the residual is added as it is; ``pool``:
    (kernel, stride, padding) or None."""
    y = norm(y)
    if residual is not None:
        y = y + (residual if residual_norm is None else residual_norm(residual))
    y = smish(y)
    return y if pool is None else F.max_pool2d(y, *pool)


def tail(layer, x, norm, skip=None, pool=None):
    """``smish(norm(layer(x)) + skip)``, then a max-pool: a layer and its
    tail. ``skip``: None, a tensor added as it is, or (layer, input, norm)
    of a residual branch; ``pool``: (kernel, stride, padding) or None. The
    kernel where ``fuses`` holds for x and the modules, else
    ``local_epilogue_plain``."""
    branch = isinstance(skip, tuple)
    if fuses(x, layer, norm, *(skip[0::2] if branch else ())):
        return local_epilogue(layer, x, norm, skip, pool)
    residual, residual_norm = skip, None
    if branch:
        residual, residual_norm = skip[0](skip[1]), skip[2]
    return local_epilogue_plain(layer(x), norm, residual, residual_norm, pool)


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

    def forward(self, x, pool=None):
        """``pool``: (kernel, stride, padding) of a max-pool after the block."""
        h = tail(self.conv1[0], x, self.conv1[1])
        skip = x if self.downsample is None else (self.downsample[0], x, self.downsample[1])
        return tail(self.conv2[0], h, self.conv2[1], skip, pool)


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
        with span("local_stage"):
            y = tail(self.conv1[0], x.permute(0, 3, 1, 2), self.conv1[1], pool=(3, 2, 1))
            y = self.layer0[0](y, pool=(3, 2, 1))
            y = self.layer2[0](self.layer1[0](y))
            y = self.layer3[0](y, pool=(2, 2, 0))
            flatten, fc1, bn, _, fc2 = self.fc
            return fc2(tail(fc1, flatten(y), bn))
