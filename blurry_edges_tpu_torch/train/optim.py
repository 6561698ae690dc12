"""The optimizer of the trainers and the initialisation they start from.

Counterparts of the JAX package's ``train/local.py`` (:51-82), which builds
``optax.chain(clip_by_global_norm(1.0), inject_hyperparams(adamw)(lr))``:

- ``make_optimizer``: ``torch.optim.AdamW`` with optax's defaults, betas
  (0.9, 0.999), eps 1e-8 and weight decay 1e-4 (torch's own default decay
  is 0.01), applied to every parameter as optax applies it (decoupled,
  scaled by the learning rate);
- ``clip_by_global_norm_``: optax's clip, g * max/norm when the global norm
  reaches max (``torch.nn.utils.clip_grad_norm_`` divides by norm + 1e-6);
- ``set_lr`` / ``current_lr``: the injected learning rate, through the
  optimizer's ``param_groups``;
- ``xavier_reinit``: Xavier normal (truncated at two standard deviations,
  as ``jax.nn.initializers.xavier_normal``) with the fans of the Flax
  parameter shapes, zero biases, unit norm scales (LayerNorm and
  BatchNorm, whose running statistics are left as they are);
- ``flax_default_init``: Flax's own defaults, which the JAX package's
  depth-completion trainer starts its U-Net from (``model.init``, no
  Xavier): LeCun normal kernels truncated at two standard deviations, zero
  biases, unit BatchNorm scales and fresh running statistics.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from ..models.global_stage import SelfAttention

# jax's truncated_normal init divides the standard deviation by the std of
# a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def make_optimizer(params, lr: float) -> torch.optim.AdamW:
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


@torch.no_grad()
def clip_by_global_norm_(params, max_norm: float = 1.0) -> torch.Tensor:
    """Scale every gradient by max_norm / norm when the global L2 norm of
    all of them is at least max_norm (optax.clip_by_global_norm), in place
    and without a host sync; returns the norm before clipping."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale)
    return norm


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def current_lr(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def _truncated_normal_(t: torch.Tensor, std: float, g: torch.Generator):
    """Normal draws of standard deviation ``std`` truncated at two of them,
    drawn on the CPU from ``g`` and copied, so a model gets the same
    weights on every device."""
    draw = torch.empty(t.shape, dtype=t.dtype)
    t.copy_(nn.init.trunc_normal_(draw, std=std, a=-2.0 * std, b=2.0 * std, generator=g))


def _xavier_(t: torch.Tensor, fan_in: int, fan_out: int, g: torch.Generator):
    _truncated_normal_(t, math.sqrt(2.0 / (fan_in + fan_out)) / _TRUNC_STD, g)


@torch.no_grad()
def xavier_reinit(model: nn.Module, g: torch.Generator) -> None:
    """Re-initialise ``model`` in place as the JAX package initialises the
    Flax model it mirrors (Flax default init, then Xavier normal on every
    parameter of rank > 1), with draws from the CPU generator ``g``.

    Fans follow the Flax shapes: a Dense kernel (in, out) gives (in, out);
    a Conv kernel (kh, kw, in, out) gives (kh * kw * in, kh * kw * out);
    each of the q/k/v DenseGeneral kernels (d, heads, hd) gives
    (heads * d, hd * d); the out kernel (heads, hd, d) gives
    (hd * heads, d * heads). Rank-1 parameters keep Flax's defaults: zero
    biases, unit LayerNorm and BatchNorm scales.
    """
    out_projs = set()
    for mod in model.modules():
        if isinstance(mod, SelfAttention):
            w = mod.in_proj_weight                              # (3d, d)
            d, heads = w.shape[1], mod.nhead
            hd = d // heads
            for part in w.split(d, dim=0):
                _xavier_(part, heads * d, hd * d, g)
            mod.in_proj_bias.zero_()
            _xavier_(mod.out_proj.weight, hd * heads, d * heads, g)
            mod.out_proj.bias.zero_()
            out_projs.add(mod.out_proj)
        elif isinstance(mod, nn.Linear):
            if mod not in out_projs:
                _xavier_(mod.weight, mod.in_features, mod.out_features, g)
                mod.bias.zero_()
        elif isinstance(mod, nn.Conv2d) and mod.groups == 1:
            o, i, kh, kw = mod.weight.shape
            _xavier_(mod.weight, kh * kw * i, kh * kw * o, g)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.LayerNorm, nn.BatchNorm1d, nn.BatchNorm2d)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif any(True for _ in mod.parameters(recurse=False)):
            raise NotImplementedError(f"no Flax counterpart for {type(mod).__name__}")


@torch.no_grad()
def flax_default_init(model: nn.Module, g: torch.Generator) -> None:
    """Initialise ``model`` in place as Flax's defaults initialise the Flax
    model it mirrors, with draws from the CPU generator ``g``: every Conv,
    ConvTranspose and Dense kernel LeCun normal (std sqrt(1 / fan_in)
    truncated at two standard deviations, jax's ``lecun_normal``), fan_in
    from the Flax kernel shape (kh, kw, in, out) -> kh * kw * in for both
    convolutions (torch's ConvTranspose2d holds (in, out, kh, kw)), a Dense
    kernel's in; biases zero; BatchNorm scales one, biases zero, running
    mean zero and variance one."""
    for mod in model.modules():
        if isinstance(mod, nn.ConvTranspose2d):
            i, _, kh, kw = mod.weight.shape
            fan_in = kh * kw * i
        elif isinstance(mod, nn.Conv2d) and mod.groups == 1:
            _, i, kh, kw = mod.weight.shape
            fan_in = kh * kw * i
        elif isinstance(mod, nn.Linear):
            fan_in = mod.in_features
        elif isinstance(mod, (nn.BatchNorm1d, nn.BatchNorm2d)):
            mod.reset_parameters()
            continue
        elif any(True for _ in mod.parameters(recurse=False)):
            raise NotImplementedError(f"no Flax counterpart for {type(mod).__name__}")
        else:
            continue
        _truncated_normal_(mod.weight, math.sqrt(1.0 / fan_in) / _TRUNC_STD, g)
        if mod.bias is not None:
            mod.bias.zero_()
