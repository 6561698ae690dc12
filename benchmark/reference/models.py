"""The three networks of Blurry-Edges in plain PyTorch, float32, under the
reference repository's state-dict keys (guo-research-group/Blurry-Edges,
``models/local_stage.py``, ``models/global_stage.py``,
``models/depth_completion_unet.py``).

The benchmark's own copy: it imports nothing of the program, and loads the
same tensors the program is given. Evaluation mode is all the serving
comparison needs (BatchNorm on its running statistics). The global stage
also has the training forward of the global trainer with attention by
exact softmax and no dropout of the attention probabilities (the program's
``attn_impl="flash"``): residual and feed-forward dropout at ``dropout``,
each mask drawn by ``torch.rand`` from a seed keyed as ``keying.py`` keys
it, so the same seed gives the same masks on the same device.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .keying import fold_in


def smish(x):
    return x * torch.tanh(torch.log1p(torch.sigmoid(x)))


class Smish(nn.Module):
    def forward(self, x):
        return smish(x)


class ResidualBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = nn.Sequential(nn.Conv2d(cin, cout, 3, padding=1), nn.BatchNorm2d(cout), Smish())
        self.conv2 = nn.Sequential(nn.Conv2d(cout, cout, 3, padding=1), nn.BatchNorm2d(cout))
        self.downsample = (nn.Sequential(nn.Conv2d(cin, cout, 1), nn.BatchNorm2d(cout))
                           if cin != cout else None)

    def forward(self, x):
        skip = x if self.downsample is None else self.downsample(x)
        return smish(self.conv2(self.conv1(x)) + skip)


class LocalStage(nn.Module):
    """(P, 21, 21, 3) patches, channels last -> (P, 10) raw parameters."""

    def __init__(self, widths=(96, 256, 384, 256), out: int = 10):
        super().__init__()
        self.conv1 = nn.Sequential(nn.Conv2d(3, 64, 7, padding=3), nn.BatchNorm2d(64), Smish())
        ins = (64,) + tuple(widths[:-1])
        for k, (i, o) in enumerate(zip(ins, widths)):
            setattr(self, f"layer{k}", nn.Sequential(ResidualBlock(i, o)))
        self.fc = nn.Sequential(nn.Flatten(), nn.Linear(widths[-1] * 9, 1024),
                                nn.BatchNorm1d(1024), Smish(), nn.Linear(1024, out))

    def forward(self, x):
        y = F.max_pool2d(self.conv1(x.permute(0, 3, 1, 2)), 3, 2, padding=1)
        y = F.max_pool2d(self.layer0(y), 3, 2, padding=1)
        y = F.max_pool2d(self.layer3(self.layer2(self.layer1(y))), 2, 2)
        return self.fc(y)


def keyed_dropout(x, rate: float, seed):
    """Inverted dropout with its mask from ``torch.rand`` under ``seed``."""
    if seed is None or rate == 0.0:
        return x
    g = torch.Generator(device=x.device)
    g.manual_seed(seed)
    u = torch.rand(x.shape, generator=g, device=x.device, dtype=x.dtype)
    return torch.where(u < 1.0 - rate, x / (1.0 - rate), 0.0)


def positional_encoding(d_model: int, max_len: int, stride: int) -> np.ndarray:
    """The reference's fixed 2-D sin/cos encoding, rows in the first half of
    the features and columns in the second, positions scaled by the stride."""
    half = d_model // 2
    pos = np.linspace(0, (max_len - 1) * stride, max_len)
    div = np.exp(np.arange(0, half, 2) * (-2.0 * np.log(10000.0) / d_model))
    pe = np.zeros((max_len, max_len, d_model), dtype=np.float32)
    pe[:, :, 0:half:2] = np.sin(pos[:, None, None] * div)
    pe[:, :, 1:half:2] = np.cos(pos[:, None, None] * div)
    pe[:, :, half::2] = np.sin(pos[None, :, None] * div)
    pe[:, :, half + 1::2] = np.cos(pos[None, :, None] * div)
    return pe.reshape(max_len * max_len, d_model)


class SelfAttention(nn.Module):
    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        self.out_proj = nn.Linear(d, d)

    def forward(self, x):
        B, L, D = x.shape
        hd = D // self.heads
        q, k, v = (t.reshape(B, L, self.heads, hd).transpose(1, 2)
                   for t in F.linear(x, self.in_proj_weight, self.in_proj_bias).split(D, -1))
        p = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd), dim=-1)
        return self.out_proj(torch.matmul(p, v).transpose(1, 2).reshape(B, L, D))


class EncoderLayer(nn.Module):
    """Post-norm: x = LN(x + Drop(Attn x)); x = LN(x + Drop(W2 Drop(relu W1 x)))."""

    def __init__(self, d: int, heads: int, ff: int, eps: float, dropout: float):
        super().__init__()
        self.dropout = dropout
        self.self_attn = SelfAttention(d, heads)
        self.linear1 = nn.Linear(d, ff)
        self.linear2 = nn.Linear(ff, d)
        self.norm1 = nn.LayerNorm(d, eps=eps)
        self.norm2 = nn.LayerNorm(d, eps=eps)

    def forward(self, x, seed=None):
        p = self.dropout
        k = (lambda i: None) if seed is None else (lambda i: fold_in(seed, i))
        x = self.norm1(x + keyed_dropout(self.self_attn(x), p, k(1)))
        h = keyed_dropout(torch.relu(self.linear1(x)), p, k(2))
        return self.norm2(x + keyed_dropout(self.linear2(h), p, k(3)))


class Encoder(nn.Module):
    def __init__(self, n: int, d: int, heads: int, ff: int, eps: float, dropout: float):
        super().__init__()
        self.layers = nn.ModuleList(EncoderLayer(d, heads, ff, eps, dropout) for _ in range(n))
        self.norm = nn.LayerNorm(d, eps=eps)

    def forward(self, x, seed=None):
        for i, layer in enumerate(self.layers):
            x = layer(x, None if seed is None else fold_in(seed, i))
        return self.norm(x)


class GlobalStage(nn.Module):
    """(B, L, 38) tokens -> (B, L, 12); ``seed`` given: the training forward."""

    def __init__(self, max_len: int = 64, stride: int = 2, n_in: int = 38, n_out: int = 12,
                 d_model: int = 128, nhead: int = 8, num_layers: int = 8, ff: int = 256,
                 eps: float = 1e-5, dropout: float = 0.1):
        super().__init__()
        self.in_src_projection = nn.Linear(n_in, d_model)
        self.encoder = Encoder(num_layers, d_model, nhead, ff, eps, dropout)
        self.generator = nn.Linear(d_model, n_out)
        self.register_buffer("pe", torch.from_numpy(positional_encoding(d_model, max_len, stride)),
                             persistent=False)

    def forward(self, src, seed=None):
        x = self.in_src_projection(src) + self.pe[None, :src.shape[1]]
        return self.generator(self.encoder(x, seed))


class DoubleConv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.double_conv = nn.Sequential(
            nn.Conv2d(cin, cout, 3, padding=1, bias=False), nn.BatchNorm2d(cout), nn.ReLU(),
            nn.Conv2d(cout, cout, 3, padding=1, bias=False), nn.BatchNorm2d(cout), nn.ReLU())

    def forward(self, x):
        return self.double_conv(x)


class Down(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.maxpool_conv = nn.Sequential(nn.MaxPool2d(2), DoubleConv(cin, cout))

    def forward(self, x):
        return self.maxpool_conv(x)


class Up(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.up = nn.ConvTranspose2d(cin, cin // 2, 2, stride=2)
        self.conv = DoubleConv(cin, cout)

    def forward(self, x, skip):
        x = self.up(x)
        dh, dw = skip.shape[2] - x.shape[2], skip.shape[3] - x.shape[3]
        x = F.pad(x, [dw // 2, dw - dw // 2, dh // 2, dh - dh // 2])
        return self.conv(torch.cat([skip, x], dim=1))


class OutConv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 1)

    def forward(self, x):
        return self.conv(x)


class UNet(nn.Module):
    """(B, 1, H, W) sparse depth -> (B, 1, H, W) dense depth."""

    def __init__(self):
        super().__init__()
        self.inc = DoubleConv(1, 64)
        self.down1, self.down2 = Down(64, 128), Down(128, 256)
        self.down3, self.down4 = Down(256, 512), Down(512, 1024)
        self.up1, self.up2 = Up(1024, 512), Up(512, 256)
        self.up3, self.up4 = Up(256, 128), Up(128, 64)
        self.outc = OutConv(64, 1)

    def forward(self, x):
        x1 = self.inc(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        y = self.up1(self.down4(x4), x4)
        y = self.up3(self.up2(y, x3), x2)
        return self.outc(self.up4(y, x1))


def build(name: str, state_dict: dict, device, **kw) -> nn.Module:
    """One network by name ('local', 'global', 'unet') with ``state_dict``
    loaded strictly, in eval mode on ``device``."""
    model = {"local": LocalStage, "global": GlobalStage, "unet": UNet}[name](**kw)
    model.load_state_dict(state_dict, strict=True)
    return model.to(device).eval()
