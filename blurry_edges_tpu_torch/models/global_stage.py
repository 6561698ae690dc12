"""Global-stage transformer: one token per patch of the Hp x Wp grid
(4,096 tokens at 147x147, R=21, stride 2), 38 input features (2 images x 19),
12 outputs (4 shared corner coordinates, 4 shared angles, 2 eta coefficients
per image).

Linear 38 -> 128, a fixed 2-D sin/cos positional encoding scaled by the
patch stride, post-norm encoder layers (d_model 128, 8 heads, FFN 256 relu,
LayerNorm eps 1e-5), a final norm and a linear 128 -> 12 head (~1.1 M
parameters). Attention is exact softmax attention written as two
``torch.matmul`` and a softmax. Inference only: no dropout. Module names
follow the reference state dict (``in_src_projection``,
``encoder.layers.{i}.self_attn.in_proj_weight``, ``generator``, ...).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn


def sincos_2d_positional_encoding(d_model: int, max_len: int, stride: int) -> np.ndarray:
    """(max_len * max_len, d_model): the first half of the features encodes the
    row position, the second half the column, interleaved sin/cos at
    geometrically spaced frequencies; positions scaled by the stride."""
    d_half = d_model // 2
    position = np.linspace(0, (max_len - 1) * stride, max_len)
    div_term = np.exp(np.arange(0, d_half, 2) * (-2.0 * np.log(10000.0) / d_model))
    pe = np.zeros((max_len, max_len, d_model), dtype=np.float32)
    pe[:, :, 0:d_half:2] = np.sin(position[:, None, None] * div_term[None, None, :])
    pe[:, :, 1:d_half:2] = np.cos(position[:, None, None] * div_term[None, None, :])
    pe[:, :, d_half:d_model:2] = np.sin(position[None, :, None] * div_term[None, None, :])
    pe[:, :, d_half + 1:d_model:2] = np.cos(position[None, :, None] * div_term[None, None, :])
    return pe.reshape(max_len * max_len, d_model)


class SelfAttention(nn.Module):
    """Multi-head self-attention with packed q/k/v projections."""

    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        self.nhead = nhead
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x):
        B, L, D = x.shape
        hd = D // self.nhead
        qkv = torch.nn.functional.linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = (t.reshape(B, L, self.nhead, hd).transpose(1, 2)
                   for t in qkv.split(D, dim=-1))              # (B, heads, L, hd)
        logits = torch.matmul(q / math.sqrt(hd), k.transpose(-1, -2))
        probs = torch.softmax(logits, dim=-1)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(B, L, D)
        return self.out_proj(out)


class EncoderLayer(nn.Module):
    """Post-norm layer: x = LN(x + SelfAttn(x)); x = LN(x + W2 relu(W1 x))."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 layer_norm_eps: float):
        super().__init__()
        self.self_attn = SelfAttention(d_model, nhead)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=layer_norm_eps)
        self.norm2 = nn.LayerNorm(d_model, eps=layer_norm_eps)

    def forward(self, x):
        x = self.norm1(x + self.self_attn(x))
        return self.norm2(x + self.linear2(torch.relu(self.linear1(x))))


class Encoder(nn.Module):
    def __init__(self, num_layers: int, d_model: int, nhead: int,
                 dim_feedforward: int, layer_norm_eps: float):
        super().__init__()
        self.layers = nn.ModuleList(
            EncoderLayer(d_model, nhead, dim_feedforward, layer_norm_eps)
            for _ in range(num_layers))
        self.norm = nn.LayerNorm(d_model, eps=layer_norm_eps)

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return self.norm(x)


class GlobalStage(nn.Module):
    """Input (B, L, in_parameter_size) with L <= max_len**2 tokens in
    row-major patch-grid order; output (B, L, out_parameter_size)."""

    def __init__(self, max_len: int = 64, stride: int = 2,
                 in_parameter_size: int = 38, out_parameter_size: int = 12,
                 d_model: int = 128, nhead: int = 8,
                 num_encoder_layers: int = 8, dim_feedforward: int = 256,
                 layer_norm_eps: float = 1e-5):
        super().__init__()
        self.in_src_projection = nn.Linear(in_parameter_size, d_model)
        self.encoder = Encoder(num_encoder_layers, d_model, nhead,
                               dim_feedforward, layer_norm_eps)
        self.generator = nn.Linear(d_model, out_parameter_size)
        pe = sincos_2d_positional_encoding(d_model, max_len, stride)
        self.register_buffer("pe", torch.from_numpy(pe), persistent=False)

    def forward(self, src):
        x = self.in_src_projection(src) + self.pe[None, :src.shape[1], :]
        return self.generator(self.encoder(x))
