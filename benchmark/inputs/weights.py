"""Seeded weights of the three networks, made on the device in a few large
draws, under the reference repository's state-dict keys.

Each network takes its trainer's initialisation: the local and global
stages Xavier normal (truncated at two standard deviations, the fans of the
Flax kernel shapes), the depth-completion U-Net LeCun normal (Flax's
default); biases zero, norm scales one, BatchNorm's running statistics
fresh (mean 0, variance 1). The same tensors go to the program and to the
reference."""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from ..reference import models as ref

# the standard deviation of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _plan(model: nn.Module, init: str) -> tuple:
    """(draws, constants): draws [(key, shape, std)], constants {key: (shape, value)}."""
    draws, consts = [], {}
    for prefix, mod in model.named_modules():
        key = (prefix + ".") if prefix else ""
        if isinstance(mod, ref.SelfAttention):
            d, h = mod.in_proj_weight.shape[1], mod.heads
            for i, part in enumerate("qkv"):
                draws.append((key + f"in_proj_weight/{i}", (d, d),
                              math.sqrt(2.0 / (h * d + d * d // h))))
            consts[key + "in_proj_bias"] = ((3 * d,), 0.0)
            draws.append((key + "out_proj.weight", (d, d), math.sqrt(2.0 / (d + d * h))))
            consts[key + "out_proj.bias"] = ((d,), 0.0)
        elif isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            if key + "weight" in {k for k, *_ in draws}:
                continue                                  # the attention's out_proj
            w = mod.weight.shape
            if isinstance(mod, nn.Linear):
                fan_in, fan_out = w[1], w[0]
            elif isinstance(mod, nn.ConvTranspose2d):     # (in, out, kh, kw)
                fan_in, fan_out = w[0] * w[2] * w[3], w[1] * w[2] * w[3]
            else:                                         # (out, in, kh, kw)
                fan_in, fan_out = w[1] * w[2] * w[3], w[0] * w[2] * w[3]
            std = (math.sqrt(2.0 / (fan_in + fan_out)) if init == "xavier"
                   else math.sqrt(1.0 / fan_in))
            draws.append((key + "weight", tuple(w), std))
            if mod.bias is not None:
                consts[key + "bias"] = ((w[1] if isinstance(mod, nn.ConvTranspose2d) else w[0],), 0.0)
        elif isinstance(mod, (nn.BatchNorm1d, nn.BatchNorm2d, nn.LayerNorm)):
            n = mod.weight.shape
            consts[key + "weight"], consts[key + "bias"] = (tuple(n), 1.0), (tuple(n), 0.0)
            if not isinstance(mod, nn.LayerNorm):
                consts[key + "running_mean"] = (tuple(n), 0.0)
                consts[key + "running_var"] = (tuple(n), 1.0)
                consts[key + "num_batches_tracked"] = ((), 0)
    return draws, consts


INITS = {"local": "xavier", "global": "xavier", "unet": "lecun"}


def make_weights(seed: int, device, nets=("local", "global", "unet"), global_kw=None) -> dict:
    """{net: state dict} from ``seed``: one uniform draw on ``device`` for
    all random tensors, mapped to a normal truncated at +-2 by the inverse
    error function and scaled by each tensor's standard deviation."""
    plans = {}
    with torch.device("meta"):
        for n in nets:
            model = ref.GlobalStage(**(global_kw or {})) if n == "global" else \
                {"local": ref.LocalStage, "unet": ref.UNet}[n]()
            plans[n] = _plan(model, INITS[n])
    total = sum(math.prod(s) for d, _ in plans.values() for _, s, _ in d)
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))
    u = torch.rand(total, generator=g, device=device, dtype=torch.float64)
    lo = 0.5 * math.erfc(2.0 / math.sqrt(2.0))            # Phi(-2)
    z = (math.sqrt(2.0) * torch.erfinv(2.0 * (lo + u * (1.0 - 2.0 * lo)) - 1.0)).float()
    del u
    out, at = {}, 0
    for n, (draws, consts) in plans.items():
        sd, parts = {}, {}
        for key, shape, std in draws:
            k = math.prod(shape)
            t = z[at:at + k].reshape(shape) * (std / _TRUNC_STD)
            at += k
            if "/" in key:
                base = key.split("/")[0]
                parts.setdefault(base, []).append(t)
            else:
                sd[key] = t.contiguous()
        for base, ts in parts.items():
            sd[base] = torch.cat(ts).contiguous()
        for key, (shape, value) in consts.items():
            dtype = torch.long if key.endswith("num_batches_tracked") else torch.float32
            sd[key] = torch.full(shape, value, dtype=dtype, device=device)
        out[n] = sd
    return out
