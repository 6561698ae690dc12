"""The port's models as a pipeline holds them (``InferenceModules``), and
their weights.

``jax_local_to_torch``, ``jax_global_to_torch`` and ``jax_unet_to_torch`` map
a Flax parameter tree of the JAX package (as numpy arrays) onto this
package's state dicts, with the reference key names: they invert the JAX
package's torch -> Flax converter (conv HWIO -> OIHW, dense (in, out) ->
(out, in), the transposed convolution's spatial flip, BatchNorm and
LayerNorm names, the fc1 flatten order, the packed q/k/v). Reading the
committed Orbax checkpoints needs JAX, so that stays with the caller.

``random_modules`` builds seeded full-width models for runs without weights.

``load_inference_modules`` builds the models of an evaluation from
``<model_path>/<name>.pth`` state dicts (reference keys: a reference
``pretrained_*.pth`` and one written by the root tool
``export_torch_assets.py`` from a committed checkpoint load the same way),
resolving each stage by the JAX package's names and order
(``utils/weights.py:28-103`` there), and prints the file each stage
resolved to.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..utils.device import resolve_device
from .global_stage import GlobalStage, SelfAttention
from .local_stage import LocalStage
from .unet import UNet

StateDict = Dict[str, torch.Tensor]


@dataclasses.dataclass
class InferenceModules:
    """The models of the pipeline, with their weights; the U-Net only for
    ``densify="pp"``."""

    local_model: LocalStage
    global_model: GlobalStage
    unet_model: Optional[UNet] = None


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


def random_modules(generator: torch.Generator, device="cuda", unet: bool = False,
                   dtype=torch.float32):
    """Full-width LocalStage and GlobalStage (and, with ``unet``, the
    depth-completion U-Net) with seeded random weights, in eval mode on
    ``device``, computing in ``dtype``, as ``InferenceModules``.
    The two stages take the same draws with or without the U-Net, and in
    either dtype."""
    device = resolve_device(device)
    local, glob = LocalStage(dtype=dtype), GlobalStage(dtype=dtype)
    _randomize(local, generator)
    _randomize(glob, generator)
    unet_model = None
    if unet:
        unet_model = UNet(dtype=dtype)
        _randomize(unet_model, generator)
        unet_model = unet_model.to(device).eval()
    return InferenceModules(local_model=local.to(device).eval(),
                            global_model=glob.to(device).eval(), unet_model=unet_model)


LOCAL_NAMES = ("pretrained_local_stage", "best_run_exp_local_stage")
UNET_NAMES = ("pretrained_depth_completion_pp", "best_run_exp_depth_completion_pp")
EXPORT_TOOL = "export_torch_assets.py"


def global_names(densify: Optional[str] = None, big: bool = False) -> Tuple[str, ...]:
    """The global stage's candidate names, in the JAX package's order: the
    ``w`` variant's own stage for densify ``w``, the big path's own stage
    for the 587x587 path, each falling back to the shared one."""
    shared = ("pretrained_global_stage", "best_run_exp_global_stage")
    if densify == "w":
        return ("pretrained_global_stage_w", "best_run_exp_global_stage_w") + shared
    if big:
        return ("pretrained_global_stage_big", "best_run_exp_global_stage_big") + shared
    return shared


def resolve_weights(model_path: str, names) -> Optional[str]:
    """The first ``<model_path>/<name>.pth`` of ``names`` that exists, or
    None. A name that exists only as a directory (an Orbax checkpoint of the
    JAX package, which only JAX reads) raises, naming the export tool."""
    for name in names:
        pth = os.path.join(model_path, f"{name}.pth")
        if os.path.exists(pth):
            return pth
        if os.path.isdir(os.path.join(model_path, name)):
            raise FileNotFoundError(
                f"{os.path.join(model_path, name)} is an Orbax checkpoint, which only JAX "
                f"reads; write it as {name}.pth with `python {EXPORT_TOOL} weights` on a "
                f"machine with JAX and point --model_path at the output")
    return None


def load_inference_modules(args, densify: Optional[str] = None,
                           allow_random: bool = False, big: bool = False,
                           device="cuda"):
    """The models of an evaluation on ``device``, in eval mode, built in
    ``args.serve_dtype`` (float32 or bfloat16; the weights stay float32):
    the LocalStage, the GlobalStage (``global_names(densify, big)``) and,
    for densify ``pp``, the U-Net. Each stage loads the first of its names
    found as ``<args.model_path>/<name>.pth``; with none found it raises,
    or with ``allow_random`` takes seeded random weights. Prints what each
    stage resolved to."""
    device = resolve_device(device)
    dtype = (torch.bfloat16 if getattr(args, "serve_dtype", "float32") == "bfloat16"
             else torch.float32)
    stages = [("local", LocalStage, LOCAL_NAMES),
              ("global", GlobalStage, global_names(densify, big))]
    if densify == "pp":
        stages.append(("unet", UNet, UNET_NAMES))
    g = torch.Generator().manual_seed(0)
    built = {}
    for stage, cls, names in stages:
        model = cls(dtype=dtype)
        path = resolve_weights(args.model_path, names)
        if path is not None:
            model.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
            print(f"weights: {stage} stage <- {path}", flush=True)
        elif allow_random:
            _randomize(model, g)
            print(f"weights: {stage} stage <- seeded random weights (none of {names} "
                  f"under {args.model_path})", flush=True)
        else:
            raise FileNotFoundError(f"no weights for any of {names} under {args.model_path}")
        built[stage] = model.to(device).eval()
    return InferenceModules(local_model=built["local"], global_model=built["global"],
                            unet_model=built.get("unet"))
