"""The three networks of Blurry-Edges in plain PyTorch at the rounding points
of the bfloat16 serving configuration, under the reference repository's
state-dict keys (guo-research-group/Blurry-Edges, ``models/local_stage.py``,
``models/global_stage.py``, ``models/depth_completion_unet.py``), in
evaluation mode.

The parameters stay float32; the networks compute in bfloat16 where the JAX
package's Flax modules with ``dtype=bfloat16`` round (its ``--serve_dtype
bfloat16``):

- a convolution, linear layer or transposed convolution rounds its input
  and its kernel to bfloat16, takes their product with float32 sums,
  rounds the product to bfloat16, and adds the bias, rounded to bfloat16,
  in bfloat16 (Flax's ``promote_dtype`` then ``y += bias``);
- BatchNorm and LayerNorm compute in float32 and return bfloat16;
- activations, pooling, padding, concatenation and the residual sums are
  bfloat16, each operation rounded: the sigmoid inside Smish is
  1 / (1 + exp(-x)) with each step rounded, as XLA expands ``nn.sigmoid``;
- the global stage adds the positional encoding after rounding it, scales q
  by 1/sqrt(head size) in bfloat16, takes q.k^T and probs.v as products
  above, and runs ``jax.nn.softmax`` in bfloat16: the max, the
  difference, the exponentials and the quotient rounded, the sum
  accumulated in float32 and rounded;
- each network returns its bfloat16 output as float32.

The benchmark's own copy, written from the JAX package's Flax modules: it
imports nothing of the program. It takes its products, norms and
reductions from PyTorch's own bfloat16 operations, as the float32
reference takes its float32 ones: on the same device and shapes these are
the library's kernels that a program computing at the same rounding
points also reaches, so the two agree to the bit wherever their rounding
points agree. In this model one bfloat16 rounding that differs anywhere
(a sum in another order, an operation rounded once where it should round
twice) grows, layer by layer, into gaps of a bfloat16 ulp over the whole
output and some percent of the folded depth, so a reference with float32
arithmetic of its own would sit as far from the program as a wrong
rounding point. Departures, none of which moves a rounding point:

- a product's float32 sums are the library's (cuDNN's and cuBLAS's
  bfloat16 kernels sum in float32; the order is theirs), where Flax's are
  XLA's;
- the transcendental functions (exp, tanh, log1p) are PyTorch's, which
  can differ from XLA's in their last bit;
- BatchNorm on its running statistics is PyTorch's eval ``batch_norm``
  with float32 statistics (float32 arithmetic, a bfloat16 result), and
  LayerNorm PyTorch's ``layer_norm`` on a float32 copy: Flax writes the
  same float32 formulas in another order;
- no dropout and no training forward: serving alone.

The control (``build(..., control=True)``) rounds the operands of every
network product to float8 e4m3 instead, each tensor scaled by its absolute
maximum over 448 (the largest e4m3 number), the lower precision that serving
stacks on Hopper use; the rest is as above.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .models import positional_encoding

BF16 = torch.bfloat16
E4M3_MAX = 448.0


def bf16_operand(t):
    """A product's operand as the configuration rounds it."""
    return t.to(BF16)


def fp8_operand(t):
    """The control's operand: float8 e4m3, scaled per tensor by its absolute
    maximum over 448, held in bfloat16 for the product."""
    scale = t.detach().abs().amax().float().clamp_min(1e-30) / E4M3_MAX
    return ((t.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(BF16)


def _biased(y, bias, channel_dim: int):
    """The bfloat16 product plus the bias, rounded to bfloat16, in bfloat16."""
    if bias is None:
        return y
    shape = [1] * y.dim()
    shape[channel_dim] = -1
    return y + bias.to(BF16).view(shape)


class Conv2d(nn.Conv2d):
    operand = staticmethod(bf16_operand)

    def forward(self, x):
        y = F.conv2d(self.operand(x), self.operand(self.weight), None, self.stride,
                     self.padding)
        return _biased(y, self.bias, 1)


class ConvTranspose2d(nn.ConvTranspose2d):
    operand = staticmethod(bf16_operand)

    def forward(self, x):
        y = F.conv_transpose2d(self.operand(x), self.operand(self.weight), None, self.stride)
        return _biased(y, self.bias, 1)


class Linear(nn.Linear):
    operand = staticmethod(bf16_operand)

    def forward(self, x):
        return _biased(F.linear(self.operand(x), self.operand(self.weight)), self.bias, -1)


class LayerNorm(nn.LayerNorm):
    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(BF16)


def sigmoid(x):
    """``nn.sigmoid`` of a bfloat16 input as XLA expands it: each step rounded."""
    return 1.0 / (1.0 + torch.exp(-x))


def smish(x):
    return x * torch.tanh(torch.log1p(sigmoid(x)))


class Smish(nn.Module):
    def forward(self, x):
        return smish(x)


def softmax(x):
    """``jax.nn.softmax`` of a bfloat16 input over the last axis (a
    bfloat16 sum accumulates in float32 and is rounded once)."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


class ResidualBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = nn.Sequential(Conv2d(cin, cout, 3, padding=1), nn.BatchNorm2d(cout), Smish())
        self.conv2 = nn.Sequential(Conv2d(cout, cout, 3, padding=1), nn.BatchNorm2d(cout))
        self.downsample = (nn.Sequential(Conv2d(cin, cout, 1), nn.BatchNorm2d(cout))
                           if cin != cout else None)

    def forward(self, x):
        skip = x if self.downsample is None else self.downsample(x)
        return smish(self.conv2(self.conv1(x)) + skip)


class LocalStage(nn.Module):
    """(P, 21, 21, 3) float32 patches, channels last -> (P, 10) float32."""

    def __init__(self, widths=(96, 256, 384, 256), out: int = 10):
        super().__init__()
        self.conv1 = nn.Sequential(Conv2d(3, 64, 7, padding=3), nn.BatchNorm2d(64), Smish())
        ins = (64,) + tuple(widths[:-1])
        for k, (i, o) in enumerate(zip(ins, widths)):
            setattr(self, f"layer{k}", nn.Sequential(ResidualBlock(i, o)))
        self.fc = nn.Sequential(nn.Flatten(), Linear(widths[-1] * 9, 1024), nn.BatchNorm1d(1024),
                                Smish(), Linear(1024, out))

    def forward(self, x):
        y = F.max_pool2d(self.conv1(x.permute(0, 3, 1, 2)), 3, 2, padding=1)
        y = F.max_pool2d(self.layer0(y), 3, 2, padding=1)
        y = F.max_pool2d(self.layer3(self.layer2(self.layer1(y))), 2, 2)
        return self.fc(y).float()


class SelfAttention(nn.Module):
    operand = staticmethod(bf16_operand)

    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        self.out_proj = Linear(d, d)

    def forward(self, x):
        B, L, D = x.shape
        hd = D // self.heads
        op = self.operand
        qkv = _biased(F.linear(op(x), op(self.in_proj_weight)), self.in_proj_bias, -1)
        q, k, v = (t.reshape(B, L, self.heads, hd).transpose(1, 2) for t in qkv.split(D, -1))
        q = q / math.sqrt(hd)
        p = softmax(torch.matmul(op(q), op(k).transpose(-1, -2)))
        out = torch.matmul(op(p), op(v))
        return self.out_proj(out.transpose(1, 2).reshape(B, L, D))


class EncoderLayer(nn.Module):
    """Post-norm: x = LN(x + Attn x); x = LN(x + W2 relu(W1 x))."""

    def __init__(self, d: int, heads: int, ff: int, eps: float):
        super().__init__()
        self.self_attn = SelfAttention(d, heads)
        self.linear1 = Linear(d, ff)
        self.linear2 = Linear(ff, d)
        self.norm1 = LayerNorm(d, eps=eps)
        self.norm2 = LayerNorm(d, eps=eps)

    def forward(self, x):
        x = self.norm1(x + self.self_attn(x))
        return self.norm2(x + self.linear2(torch.relu(self.linear1(x))))


class Encoder(nn.Module):
    def __init__(self, n: int, d: int, heads: int, ff: int, eps: float):
        super().__init__()
        self.layers = nn.ModuleList(EncoderLayer(d, heads, ff, eps) for _ in range(n))
        self.norm = LayerNorm(d, eps=eps)

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return self.norm(x)


class GlobalStage(nn.Module):
    """(B, L, 38) float32 tokens -> (B, L, 12) float32."""

    def __init__(self, max_len: int = 64, stride: int = 2, n_in: int = 38, n_out: int = 12,
                 d_model: int = 128, nhead: int = 8, num_layers: int = 8, ff: int = 256,
                 eps: float = 1e-5):
        super().__init__()
        self.in_src_projection = Linear(n_in, d_model)
        self.encoder = Encoder(num_layers, d_model, nhead, ff, eps)
        self.generator = Linear(d_model, n_out)
        self.register_buffer("pe", torch.from_numpy(positional_encoding(d_model, max_len, stride)),
                             persistent=False)

    def forward(self, src):
        x = self.in_src_projection(src) + self.pe[None, :src.shape[1]].to(BF16)
        return self.generator(self.encoder(x)).float()


class DoubleConv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.double_conv = nn.Sequential(
            Conv2d(cin, cout, 3, padding=1, bias=False), nn.BatchNorm2d(cout), nn.ReLU(),
            Conv2d(cout, cout, 3, padding=1, bias=False), nn.BatchNorm2d(cout), nn.ReLU())

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
        self.up = ConvTranspose2d(cin, cin // 2, 2, stride=2)
        self.conv = DoubleConv(cin, cout)

    def forward(self, x, skip):
        x = self.up(x)
        dh, dw = skip.shape[2] - x.shape[2], skip.shape[3] - x.shape[3]
        x = F.pad(x, [dw // 2, dw - dw // 2, dh // 2, dh - dh // 2])
        return self.conv(torch.cat([skip, x], dim=1))


class OutConv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = Conv2d(cin, cout, 1)

    def forward(self, x):
        return self.conv(x)


class UNet(nn.Module):
    """(B, 1, H, W) float32 sparse depth -> (B, 1, H, W) float32 dense depth."""

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
        return self.outc(self.up4(y, x1)).float()


def build(name: str, state_dict: dict, device, control: bool = False, **kw) -> nn.Module:
    """One network by name ('local', 'global', 'unet') with ``state_dict``
    loaded strictly, in eval mode on ``device``; ``control``: float8
    operands in every product."""
    model = {"local": LocalStage, "global": GlobalStage, "unet": UNet}[name](**kw)
    model.load_state_dict(state_dict, strict=True)
    if control:
        for mod in model.modules():
            if hasattr(type(mod), "operand"):
                mod.operand = fp8_operand
    return model.to(device).eval()
