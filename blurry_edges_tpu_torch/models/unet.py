"""Depth-completion U-Net: the confidence-masked global depth map in, the
dense depth map out (the ``pp`` densify).

Four 2x max-pool downs and four transposed-convolution ups, 64..1024
channels, (conv3x3 without bias, BatchNorm, ReLU) x 2 at every level
(~31 M parameters). NCHW throughout: (B, 1, H, W) -> (B, 1, H, W). Pooling
floors odd sizes (147 -> 73 -> 36 -> 18 -> 9), and each upsampled map is
padded about its center to its skip's size before the two are
concatenated. Module names follow the reference state dict
(``inc.double_conv.0``, ``down{k}.maxpool_conv.1.double_conv.*``,
``up{k}.up``, ``up{k}.conv.double_conv.*``, ``outc.conv``), so a reference
``.pth`` loads as is.

``dtype=torch.bfloat16`` computes as the JAX package's ``UNet(dtype=
jnp.bfloat16)``: the convolutions and the transposed convolutions cast
their input and parameters to bfloat16 (``models/layers.py``), BatchNorm
computes in float32 and returns bfloat16, and ReLU, pooling, padding and
concatenation run in bfloat16; the output is bfloat16 and the caller casts
it back.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.trace import span
from .batchnorm import BatchNorm2d
from .layers import Conv2d, ConvTranspose2d, set_compute_dtype


class DoubleConv(nn.Module):
    """(conv3x3 without bias -> BatchNorm -> ReLU) x 2."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.double_conv = nn.Sequential(
            Conv2d(in_channels, out_channels, 3, padding=1, bias=False),
            BatchNorm2d(out_channels), nn.ReLU(inplace=True),
            Conv2d(out_channels, out_channels, 3, padding=1, bias=False),
            BatchNorm2d(out_channels), nn.ReLU(inplace=True))

    def forward(self, x):
        return self.double_conv(x)


class Down(nn.Module):
    """2x2 max-pool (floor), then a DoubleConv."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.maxpool_conv = nn.Sequential(nn.MaxPool2d(2), DoubleConv(in_channels, out_channels))

    def forward(self, x):
        return self.maxpool_conv(x)


class Up(nn.Module):
    """Transposed-conv 2x upsample to half the channels, center padding to
    the skip's size, concatenation after the skip, then a DoubleConv."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.up = ConvTranspose2d(in_channels, in_channels // 2, 2, stride=2)
        self.conv = DoubleConv(in_channels, out_channels)

    def forward(self, x, skip):
        x = self.up(x)
        dh, dw = skip.shape[2] - x.shape[2], skip.shape[3] - x.shape[3]
        x = F.pad(x, [dw // 2, dw - dw // 2, dh // 2, dh - dh // 2])
        return self.conv(torch.cat([skip, x], dim=1))


class OutConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, 1)

    def forward(self, x):
        return self.conv(x)


class UNet(nn.Module):
    """(B, n_channels, H, W) -> (B, n_classes, H, W)."""

    def __init__(self, n_channels: int = 1, n_classes: int = 1, dtype=torch.float32):
        super().__init__()
        self.inc = DoubleConv(n_channels, 64)
        self.down1 = Down(64, 128)
        self.down2 = Down(128, 256)
        self.down3 = Down(256, 512)
        self.down4 = Down(512, 1024)
        self.up1 = Up(1024, 512)
        self.up2 = Up(512, 256)
        self.up3 = Up(256, 128)
        self.up4 = Up(128, 64)
        self.outc = OutConv(64, n_classes)
        set_compute_dtype(self, dtype)

    def forward(self, x):
        with span("unet"):
            x1 = self.inc(x)
            x2 = self.down1(x1)
            x3 = self.down2(x2)
            x4 = self.down3(x3)
            y = self.up1(self.down4(x4), x4)
            y = self.up2(y, x3)
            y = self.up3(y, x2)
            return self.outc(self.up4(y, x1))
