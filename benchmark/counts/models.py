"""Floating-point operations of the networks from their shapes (a
multiply-add counts 2).

``matmul_flops`` counts the convolutions (transposed ones too) and linear
layers of one forward by forward hooks on a model run on the meta device,
so nothing is computed. The global stage's attention products and its
packed q/k/v projection are no modules, so the stage is counted by its
formula, per token: 2 n_in d + layers x (2 d 3d + 2 d d + 2 d ff + 2 ff d
+ 4 L d) + 2 d n_out."""

from __future__ import annotations

import torch

from ..reference import models as ref


def matmul_flops(model, x) -> int:
    """Multiply-add FLOPs of the convolutions and linear layers of
    ``model(x)``, counted by forward hooks."""
    total = 0

    def hook(mod, inputs, out):
        nonlocal total
        if isinstance(mod, torch.nn.Conv2d):
            k = mod.kernel_size[0] * mod.kernel_size[1]
            total += 2 * out.numel() * mod.in_channels * k // mod.groups
        else:
            total += 2 * out.numel() * mod.in_features

    def hook_transposed(mod, inputs, out):   # each input pixel times each kernel tap
        nonlocal total
        total += 2 * inputs[0].numel() * mod.out_channels * mod.kernel_size[0] * mod.kernel_size[1]

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    handles += [m.register_forward_hook(hook_transposed) for m in model.modules()
                if isinstance(m, torch.nn.ConvTranspose2d)]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in handles:
            h.remove()
    return total


def global_stage_flops(L: int, d: int = 128, layers: int = 8, ff: int = 256, n_in: int = 38,
                       n_out: int = 12) -> int:
    """One sample's forward over L tokens."""
    per_layer = 2 * d * 3 * d + 2 * d * d + 2 * d * ff + 2 * ff * d + 4 * L * d
    return L * (2 * n_in * d + layers * per_layer + 2 * d * n_out)


def local_stage_flops(patches: int, R: int) -> int:
    with torch.device("meta"):
        return matmul_flops(ref.LocalStage().eval(), torch.empty(patches, R, R, 3))


def unet_flops(H: int, W: int) -> int:
    with torch.device("meta"):
        return matmul_flops(ref.UNet().eval(), torch.empty(1, 1, H, W))


def grid_tokens(size: int, R: int, stride: int) -> int:
    return ((size - R) // stride + 1) ** 2


def serve_flops_per_pair(cfg: dict) -> int:
    """The networks' work for one pair of the configuration: the local CNN
    over both images' patches and the global stage over the tokens of each
    147x147 grid (36 blocks on the block-tiled path), and the U-Net for
    the ``pp`` densify."""
    R, stride, g = cfg["R"], cfg["stride"], cfg["global_stage"]
    block = cfg.get("block", cfg["img_size"])
    L = grid_tokens(block, R, stride)
    n_blocks = cfg.get("n_blocks", 1)
    core = local_stage_flops(2 * L, R) + global_stage_flops(
        L, g["d_model"], g["num_layers"], g["dim_feedforward"], g["in_size"], g["out_size"])
    total = n_blocks * core
    if cfg["densify"] == "pp":
        total += unet_flops(cfg["img_size"], cfg["img_size"])
    return total


def train_flops_per_step(cfg: dict, batch: int) -> int:
    """3 x the global stage's forward FLOPs x the samples of a step (forward
    and backward; the recompute under checkpointing is not counted)."""
    g = cfg["global_stage"]
    L = grid_tokens(cfg["img_size"], cfg["R"], cfg["stride"])
    return 3 * batch * global_stage_flops(L, g["d_model"], g["num_layers"], g["dim_feedforward"],
                                          g["in_size"], g["out_size"])
