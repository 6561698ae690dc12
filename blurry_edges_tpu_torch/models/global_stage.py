"""Global-stage transformer: one token per patch of the Hp x Wp grid
(4,096 tokens at 147x147, R=21, stride 2), 38 input features (2 images x 19),
12 outputs (4 shared corner coordinates, 4 shared angles, 2 eta coefficients
per image).

Linear 38 -> 128, a fixed 2-D sin/cos positional encoding scaled by the
patch stride, post-norm encoder layers (d_model 128, 8 heads, FFN 256 relu,
LayerNorm eps 1e-5), a final norm and a linear 128 -> 12 head (~1.1 M
parameters). Module names follow the reference state dict
(``in_src_projection``, ``encoder.layers.{i}.self_attn.in_proj_weight``,
``generator``, ...).

Attention is exact softmax attention, by ``attn_impl``: ``"xla"`` (the
default, named after the JAX package's option) writes it as two
``torch.matmul`` and a softmax; ``"flash"`` runs the flash-attention
kernels (``ops/flash_attention.py``) and, as the JAX package's
``flash_attention_fn``, drops no attention probabilities.

``forward(src)`` is inference. ``forward(src, train=True, seed=s)`` is the
training forward (the JAX package's ``train=True``): dropout at rate
``dropout``, its masks drawn from seeds folded from ``s`` (so a recomputed
layer draws the same masks), and every layer under activation
checkpointing when gradients are on (the JAX package's per-layer
``nn.remat``). As Flax's attention does by default, one (L, L) dropout mask
of the attention probabilities is shared across the batch and the heads;
the residual and feed-forward dropouts are element-wise.

``dtype=torch.bfloat16`` computes as the JAX package's ``GlobalStage(dtype=
jnp.bfloat16)`` with Flax's ``MultiHeadDotProductAttention``: the linear
layers and the packed q/k/v projection cast their input and parameters to
bfloat16 and add their bias to the rounded product; the positional
encoding is cast to bfloat16 before it is added; q is scaled by 1/4 in
bfloat16 (exact); q.k^T and probs.v are bfloat16 products; the softmax runs
as ``jax.nn.softmax`` in bfloat16 (the max, the exponentials and the
quotient in bfloat16, the sum accumulated in float32 and rounded to
bfloat16, as ``jnp.sum`` does for a bfloat16 input); the residual sums are
bfloat16 and LayerNorm computes in float32 and returns bfloat16. The
output is bfloat16; the caller casts it back. With ``attn_impl="flash"``
q, k and v go to the float32 kernels and the result back to bfloat16, as
the JAX package's ``flash_attention_fn`` does.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..ops.flash_attention import flash_attention
from ..utils.seeding import fold_in, generator
from .layers import LayerNorm, Linear, set_compute_dtype

ATTN_IMPLS = ("xla", "flash")


def keyed_dropout(x, rate: float, seed: Optional[int], shape=None):
    """Dropout of ``x`` at ``rate`` with the mask drawn from ``seed`` (none
    when ``seed`` is None or the rate is 0); ``shape`` broadcasts one mask
    over the leading dimensions of ``x``. Kept entries scale by 1/(1-rate)."""
    if seed is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    u = torch.rand(shape or x.shape, generator=generator(seed, x.device),
                   device=x.device, dtype=x.dtype)
    return torch.where(u < keep, x / keep, 0.0)


def softmax_bf16(x):
    """``jax.nn.softmax`` of a bfloat16 input over the last axis, each
    operation rounded to bfloat16 (torch.softmax would round only its
    result)."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


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

    compute_dtype = torch.float32

    def __init__(self, d_model: int, nhead: int, dropout: float = 0.0,
                 attn_impl: str = "xla"):
        super().__init__()
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {attn_impl!r} not in {ATTN_IMPLS}")
        self.nhead = nhead
        self.dropout = dropout
        self.attn_impl = attn_impl
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = Linear(d_model, d_model)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x, seed: Optional[int] = None):
        B, L, D = x.shape
        hd = D // self.nhead
        dt = self.compute_dtype
        if dt == torch.float32:
            qkv = torch.nn.functional.linear(x, self.in_proj_weight, self.in_proj_bias)
        else:
            qkv = (torch.nn.functional.linear(x.to(dt), self.in_proj_weight.to(dt))
                   + self.in_proj_bias.to(dt))
        q, k, v = (t.reshape(B, L, self.nhead, hd).transpose(1, 2)
                   for t in qkv.split(D, dim=-1))              # (B, heads, L, hd)
        if self.attn_impl == "flash":
            out = flash_attention(q.float().contiguous(), k.float().contiguous(),
                                  v.float().contiguous(), 1.0 / math.sqrt(hd)).to(dt)
        else:
            logits = torch.matmul(q / math.sqrt(hd), k.transpose(-1, -2))
            probs = (torch.softmax(logits, dim=-1) if dt == torch.float32
                     else softmax_bf16(logits))
            probs = keyed_dropout(probs, self.dropout, seed, shape=(1, 1, L, L))
            out = torch.matmul(probs, v)
        return self.out_proj(out.transpose(1, 2).reshape(B, L, D))


class EncoderLayer(nn.Module):
    """Post-norm layer: x = LN(x + Drop(SelfAttn(x)));
    x = LN(x + Drop(W2 Drop(relu(W1 x)))). Dropout only with a seed."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 layer_norm_eps: float, dropout: float = 0.0,
                 attn_impl: str = "xla"):
        super().__init__()
        self.dropout = dropout
        self.self_attn = SelfAttention(d_model, nhead, dropout, attn_impl)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm1 = LayerNorm(d_model, eps=layer_norm_eps)
        self.norm2 = LayerNorm(d_model, eps=layer_norm_eps)

    def forward(self, x, seed: Optional[int] = None):
        if seed is None:
            x = self.norm1(x + self.self_attn(x))
            return self.norm2(x + self.linear2(torch.relu(self.linear1(x))))
        p = self.dropout
        attn = keyed_dropout(self.self_attn(x, fold_in(seed, 0)), p, fold_in(seed, 1))
        x = self.norm1(x + attn)
        h = keyed_dropout(torch.relu(self.linear1(x)), p, fold_in(seed, 2))
        h = keyed_dropout(self.linear2(h), p, fold_in(seed, 3))
        return self.norm2(x + h)


class Encoder(nn.Module):
    def __init__(self, num_layers: int, d_model: int, nhead: int,
                 dim_feedforward: int, layer_norm_eps: float,
                 dropout: float = 0.0, attn_impl: str = "xla"):
        super().__init__()
        self.layers = nn.ModuleList(
            EncoderLayer(d_model, nhead, dim_feedforward, layer_norm_eps,
                         dropout, attn_impl)
            for _ in range(num_layers))
        self.norm = LayerNorm(d_model, eps=layer_norm_eps)

    def forward(self, x, train: bool = False, seed: int = 0):
        if not train:
            for layer in self.layers:
                x = layer(x)
            return self.norm(x)
        for i, layer in enumerate(self.layers):
            s = fold_in(seed, i)
            if torch.is_grad_enabled():
                x = checkpoint(layer, x, s, use_reentrant=False)
            else:
                x = layer(x, s)
        return self.norm(x)


class GlobalStage(nn.Module):
    """Input (B, L, in_parameter_size) with L <= max_len**2 tokens in
    row-major patch-grid order; output (B, L, out_parameter_size)."""

    compute_dtype = torch.float32

    def __init__(self, max_len: int = 64, stride: int = 2,
                 in_parameter_size: int = 38, out_parameter_size: int = 12,
                 d_model: int = 128, nhead: int = 8,
                 num_encoder_layers: int = 8, dim_feedforward: int = 256,
                 layer_norm_eps: float = 1e-5, dropout: float = 0.1,
                 attn_impl: str = "xla", dtype=torch.float32):
        super().__init__()
        self.in_src_projection = Linear(in_parameter_size, d_model)
        self.encoder = Encoder(num_encoder_layers, d_model, nhead,
                               dim_feedforward, layer_norm_eps, dropout,
                               attn_impl)
        self.generator = Linear(d_model, out_parameter_size)
        pe = sincos_2d_positional_encoding(d_model, max_len, stride)
        self.register_buffer("pe", torch.from_numpy(pe), persistent=False)
        set_compute_dtype(self, dtype)

    def forward(self, src, train: bool = False, seed: int = 0):
        pe = self.pe[None, :src.shape[1], :]
        if self.compute_dtype != torch.float32:
            pe = pe.to(self.compute_dtype)
        x = self.in_src_projection(src) + pe
        return self.generator(self.encoder(x, train, seed))
