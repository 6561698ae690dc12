"""Weights for the port's models.

``jax_local_to_torch``, ``jax_global_to_torch`` and ``jax_unet_to_torch`` map
a Flax parameter tree of the JAX package (as numpy arrays) onto this
package's state dicts, with the reference key names: they invert the JAX
package's torch -> Flax converter (conv HWIO -> OIHW, dense (in, out) ->
(out, in), the transposed convolution's spatial flip, BatchNorm and
LayerNorm names, the fc1 flatten order, the packed q/k/v). Reading the
committed Orbax checkpoints needs JAX, so that stays with the caller.

``random_modules`` builds seeded full-width models for runs without weights.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn as nn

from ..models.global_stage import GlobalStage, SelfAttention
from ..models.local_stage import LocalStage
from ..models.unet import UNet
from .device import resolve_device

StateDict = Dict[str, torch.Tensor]


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def _conv(sd: StateDict, name: str, p: dict) -> None:
    """flax Conv (kh, kw, I, O) -> torch Conv2d (O, I, kh, kw)."""
    sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in p:
        sd[f"{name}.bias"] = _t(p["bias"])


def _conv_transpose(sd: StateDict, name: str, p: dict) -> None:
    """flax ConvTranspose (kh, kw, I, O) -> torch ConvTranspose2d (I, O, kh,
    kw), flipped back on both spatial axes (Flax's kernel is the mirror of
    torch's)."""
    w = np.asarray(p["kernel"]).transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
    sd[f"{name}.weight"] = _t(np.ascontiguousarray(w))
    sd[f"{name}.bias"] = _t(p["bias"])


def _dense(sd: StateDict, name: str, p: dict) -> None:
    """flax Dense (I, O) -> torch Linear (O, I)."""
    sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T)
    sd[f"{name}.bias"] = _t(p["bias"])


def _bn(sd: StateDict, name: str, p: dict, s: dict) -> None:
    sd[f"{name}.weight"] = _t(p["scale"])
    sd[f"{name}.bias"] = _t(p["bias"])
    sd[f"{name}.running_mean"] = _t(s["mean"])
    sd[f"{name}.running_var"] = _t(s["var"])
    sd[f"{name}.num_batches_tracked"] = torch.tensor(0)


def _layernorm(sd: StateDict, name: str, p: dict) -> None:
    sd[f"{name}.weight"] = _t(p["scale"])
    sd[f"{name}.bias"] = _t(p["bias"])


def jax_local_to_torch(params: dict, batch_stats: dict) -> StateDict:
    """Flax LocalStage (params, batch_stats) -> LocalStage state dict."""
    sd: StateDict = {}
    _conv(sd, "conv1.0", params["conv1"])
    _bn(sd, "conv1.1", params["bn1"], batch_stats["bn1"])
    for k in range(4):
        p, s, pre = params[f"layer{k}"], batch_stats[f"layer{k}"], f"layer{k}.0"
        _conv(sd, f"{pre}.conv1.0", p["conv1"])
        _bn(sd, f"{pre}.conv1.1", p["bn1"], s["bn1"])
        _conv(sd, f"{pre}.conv2.0", p["conv2"])
        _bn(sd, f"{pre}.conv2.1", p["bn2"], s["bn2"])
        if "proj_conv" in p:
            _conv(sd, f"{pre}.downsample.0", p["proj_conv"])
            _bn(sd, f"{pre}.downsample.1", p["proj_bn"], s["proj_bn"])

    # fc1 input: flax flattens the (3, 3, 256) map as (H, W, C), torch as
    # (C, H, W); torch column c*9 + i*3 + j takes flax row (i*3 + j)*256 + c
    kernel = np.asarray(params["fc1"]["kernel"])             # (2304, 1024)
    C, Hs, Ws = 256, 3, 3
    ii, jj, cc = np.meshgrid(np.arange(Hs), np.arange(Ws), np.arange(C), indexing="ij")
    perm = (cc * Hs * Ws + ii * Ws + jj).reshape(-1)
    w = np.empty_like(kernel.T)
    w[:, perm] = kernel.T
    sd["fc.1.weight"] = _t(w)
    sd["fc.1.bias"] = _t(params["fc1"]["bias"])
    _bn(sd, "fc.2", params["fc_bn"], batch_stats["fc_bn"])
    _dense(sd, "fc.4", params["fc2"])
    return sd


def jax_global_to_torch(params: dict) -> StateDict:
    """Flax GlobalStage params -> GlobalStage state dict (any layer count)."""
    sd: StateDict = {}
    _dense(sd, "in_src_projection", params["in_proj"])
    n_layers = sum(1 for k in params if k.startswith("layer"))
    for i in range(n_layers):
        p, pre = params[f"layer{i}"], f"encoder.layers.{i}"
        att = p["self_attn"]
        d = np.asarray(att["query"]["kernel"]).shape[0]
        # flax (d_in, heads, head_dim) per projection -> packed (3d, d_in)
        sd[f"{pre}.self_attn.in_proj_weight"] = _t(np.concatenate(
            [np.asarray(att[n]["kernel"]).reshape(d, d).T
             for n in ("query", "key", "value")]))
        sd[f"{pre}.self_attn.in_proj_bias"] = _t(np.concatenate(
            [np.asarray(att[n]["bias"]).reshape(d) for n in ("query", "key", "value")]))
        sd[f"{pre}.self_attn.out_proj.weight"] = _t(
            np.asarray(att["out"]["kernel"]).reshape(d, d).T)
        sd[f"{pre}.self_attn.out_proj.bias"] = _t(att["out"]["bias"])
        _dense(sd, f"{pre}.linear1", p["linear1"])
        _dense(sd, f"{pre}.linear2", p["linear2"])
        _layernorm(sd, f"{pre}.norm1", p["norm1"])
        _layernorm(sd, f"{pre}.norm2", p["norm2"])
    _layernorm(sd, "encoder.norm", params["final_norm"])
    _dense(sd, "generator", params["generator"])
    return sd


def _double_conv(sd: StateDict, name: str, p: dict, s: dict) -> None:
    _conv(sd, f"{name}.0", p["conv1"])
    _bn(sd, f"{name}.1", p["bn1"], s["bn1"])
    _conv(sd, f"{name}.3", p["conv2"])
    _bn(sd, f"{name}.4", p["bn2"], s["bn2"])


def jax_unet_to_torch(params: dict, batch_stats: dict) -> StateDict:
    """Flax UNet (params, batch_stats) -> UNet state dict."""
    sd: StateDict = {}
    _double_conv(sd, "inc.double_conv", params["inc"], batch_stats["inc"])
    for k in range(1, 5):
        _double_conv(sd, f"down{k}.maxpool_conv.1.double_conv", params[f"down{k}"],
                     batch_stats[f"down{k}"])
    for k in range(1, 5):
        p = params[f"up{k}"]
        _conv_transpose(sd, f"up{k}.up", p["up"])
        _double_conv(sd, f"up{k}.conv.double_conv", p["conv"], batch_stats[f"up{k}"]["conv"])
    _conv(sd, "outc.conv", params["outc"])
    return sd


def _randomize(model: nn.Module, g: torch.Generator) -> None:
    """Seeded weights: fan-in uniform for convolutions and linears, xavier
    uniform for packed q/k/v, perturbed norms and BatchNorm statistics."""

    def uniform(t, bound):
        t.copy_((torch.rand(t.shape, generator=g) * 2.0 - 1.0) * bound)

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear, nn.ConvTranspose2d)):
                # fan-in: in-channels x kernel; an output pixel of the
                # U-Net's stride-2, 2x2 transposed convolution sees one input pixel
                fan_in = (mod.in_channels if isinstance(mod, nn.ConvTranspose2d)
                          else mod.weight[0].numel())
                bound = 1.0 / math.sqrt(fan_in)
                uniform(mod.weight, bound)
                if mod.bias is not None:
                    uniform(mod.bias, bound)
            elif isinstance(mod, SelfAttention):
                w = mod.in_proj_weight
                uniform(w, math.sqrt(6.0 / (w.shape[0] // 3 + w.shape[1])))
                uniform(mod.in_proj_bias, 0.02)
            elif isinstance(mod, (nn.BatchNorm1d, nn.BatchNorm2d, nn.LayerNorm)):
                uniform(mod.weight, 0.1)
                mod.weight.add_(1.0)
                uniform(mod.bias, 0.1)
                if isinstance(mod, (nn.BatchNorm1d, nn.BatchNorm2d)):
                    uniform(mod.running_mean, 0.1)
                    uniform(mod.running_var, 0.5)
                    mod.running_var.add_(1.0)


def random_modules(generator: torch.Generator, device="cuda", unet: bool = False):
    """Full-width LocalStage and GlobalStage (and, with ``unet``, the
    depth-completion U-Net) with seeded random weights, in eval mode on
    ``device``, as ``eval.pipeline.InferenceModules``. The two stages take
    the same draws with or without the U-Net."""
    from ..eval.pipeline import InferenceModules

    device = resolve_device(device)
    local, glob = LocalStage(), GlobalStage()
    _randomize(local, generator)
    _randomize(glob, generator)
    unet_model = None
    if unet:
        unet_model = UNet()
        _randomize(unet_model, generator)
        unet_model = unet_model.to(device).eval()
    return InferenceModules(local_model=local.to(device).eval(),
                            global_model=glob.to(device).eval(), unet_model=unet_model)
