"""147x147 inference: image pair -> dense depth, confidence, the restored,
sharpened and refocused images and the boundary map.

The chain (reference blurry_edges_test.py:117-145): unfold the pair into
2 x L patches; local CNN; wedge colors per patch (wedge_colors kernel);
19-feature tokens; global transformer; denormalize and params2etas; the full
render (wedge_render kernel); overlap-add fold; the densify: a threshold on
the confidence (0.05, or 0.0 with hard wedge masks for ``densify="w"``), or
for ``densify="pp"`` the depth-completion U-Net over the folded global
depth. On CUDA tensors both wedge steps are the hand-written kernels; on
CPU tensors their plain versions. An estimator runs its models in full
float32, with TF32 off for the call whatever the caller's setting, as the
float32 reference does.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..config import CamConfig, GridConfig, PatchConfig
from ..models.global_stage import GlobalStage
from ..models.local_stage import LocalStage
from ..models.unet import UNet
from ..ops.dfd import DfDSolver
from ..ops.params import denormalize_global_eval
from ..ops.patchify import fold, fold_count, unfold
from ..ops.wedge import params2etas
from ..ops.wedge_cuda import wedge_render
from ..utils.device import float32_precision, resolve_device

DENSIFY_MODES = (None, "w", "pp")


@dataclasses.dataclass
class InferenceModules:
    """The models of the pipeline, with their weights; the U-Net only for
    ``densify="pp"``."""

    local_model: LocalStage
    global_model: GlobalStage
    unet_model: Optional[UNet] = None


# The JAX package's render_full (eval/pipeline.py:45-73): pair renders with a
# joint color solve, sharpened and refocused renders, boundary map, DfD depth
# and wedge mask, same arguments and layouts. On CUDA tensors it is the
# wedge_render kernel, on CPU tensors its plain version.
render_full = wedge_render


def fold_outputs(rend, grid: GridConfig):
    """Overlap-add every rendered patch grid into image maps (reference
    blurry_edges_test.py:95-100)."""
    H, W, R, stride = grid.H, grid.W, grid.R, grid.stride
    dm = rend["depth_mask"]
    dtype, device = rend["depth_map"].dtype, dm.device
    count = fold_count(H, W, R, stride, dtype, device)

    def fold_sum(p):  # (..., Hp, Wp, R, R, C) -> (..., H, W, C)
        lead = p.shape[:-5]
        out = fold(p.reshape((-1,) + p.shape[-5:]), H, W, stride)
        return out.reshape(lead + out.shape[1:])

    def fmean(p):
        return fold_sum(p) / count[:, :, None]

    global_image = fmean(rend["patches"])                         # (B,2,H,W,3)
    global_shpd = fmean(rend["patches_shpd"])                     # (B,H,W,3)
    global_refoc = fmean(rend["patches_refoc"])
    global_bndry = fmean(rend["local_bndry"][..., None])[..., 0]  # (B,H,W)

    num_depth = fold_sum((dm > 0).to(dtype)[..., None])[..., 0]   # (B,H,W)
    confidence = num_depth / count
    depth_sum = fold_sum(rend["depth_map"][..., None])[..., 0]
    global_depth = depth_sum / torch.where(num_depth > 0, num_depth, 1.0)

    return dict(global_image=global_image, global_shpd=global_shpd,
                global_refoc=global_refoc, global_bndry=global_bndry,
                global_depth=global_depth, confidence=confidence)


def _as_tensor(imgs) -> torch.Tensor:
    """A numpy array or tensor of images -> a float32 tensor."""
    if torch.is_tensor(imgs):
        return imgs
    return torch.from_numpy(np.ascontiguousarray(imgs, dtype=np.float32))


def _make_estimate_fn(mods: InferenceModules, patch_cfg: PatchConfig,
                      grid: GridConfig, cam: CamConfig,
                      densify: Optional[str], rho_prime: float,
                      device) -> Callable:
    """(B, 2, H, W, 3) image pairs -> maps with a leading B axis."""
    from ..train.global_precal import local_tokens

    if densify not in DENSIFY_MODES:
        raise ValueError(f"densify must be one of {DENSIFY_MODES}, got {densify!r}")
    if densify == "pp" and mods.unet_model is None:
        raise ValueError("densify='pp' needs InferenceModules.unet_model, the "
                         "depth-completion U-Net")
    device = resolve_device(device)
    mods.local_model.eval()   # inference: BatchNorm on its running statistics
    mods.global_model.eval()
    if densify == "pp":
        mods.unet_model.eval()
    dfd = DfDSolver.from_config(cam, patch_cfg)
    Hp, Wp, L, R = grid.H_patches, grid.W_patches, grid.num_tokens, grid.R
    hard = densify == "w"
    depth_thres = 0.0 if hard else 0.05

    @torch.inference_mode()
    @float32_precision()
    def estimate(imgs):
        imgs = imgs.to(device=device, dtype=torch.float32)
        B = imgs.shape[0]
        tokens, _ = local_tokens(mods.local_model, imgs, patch_cfg, grid)  # (B,2,L,19)
        src = tokens.permute(0, 2, 1, 3).reshape(B, L, 38)
        est = mods.global_model(src)
        den = denormalize_global_eval(est).reshape(B, Hp, Wp, 12)
        xy_angles = den[..., :8].contiguous()
        etas = params2etas(den[..., 8:]).contiguous()

        img_patches = unfold(imgs.reshape((B * 2,) + imgs.shape[2:]), R, grid.stride)
        img_patches = img_patches.reshape((B, 2) + img_patches.shape[1:])
        rend = render_full(xy_angles, etas, img_patches, patch_cfg, dfd,
                           rho_prime, hard)
        out = fold_outputs(rend, grid)
        if densify == "pp":
            # the raw folded depth, not the thresholded one; in eval mode one
            # pass over the batch is B single-pair passes
            out["depth_final"] = mods.unet_model(out["global_depth"][:, None])[:, 0]
        else:
            out["depth_final"] = torch.where(out["confidence"] > depth_thres,
                                             out["global_depth"], 0.0)
        return out

    return estimate


def make_depth_estimator(mods: InferenceModules, patch_cfg: PatchConfig,
                         grid: GridConfig, cam: CamConfig,
                         densify: Optional[str] = None,
                         rho_prime: float = 10.39,
                         device="cuda") -> Callable:
    """Single pair: (2, H, W, 3) -> maps with a leading axis of 1
    (global_image (1,2,H,W,3), global_shpd (1,H,W,3), confidence (1,H,W),
    ...), as the JAX ``make_depth_estimator`` returns them. ``mods`` must
    live on ``device``."""
    fn = _make_estimate_fn(mods, patch_cfg, grid, cam, densify, rho_prime, device)

    def estimate(img_pair):
        return fn(_as_tensor(img_pair)[None])

    return estimate


def make_batched_depth_estimator(mods: InferenceModules, patch_cfg: PatchConfig,
                                 grid: GridConfig, cam: CamConfig,
                                 densify: Optional[str] = None,
                                 rho_prime: float = 10.39,
                                 device="cuda") -> Callable:
    """Throughput variant: (B, 2, H, W, 3) -> the single-pair maps stacked on
    a leading B axis (global_image (B,1,2,H,W,3), confidence (B,1,H,W), ...),
    as the JAX vmapped estimator returns them; one pass over the batch."""
    fn = _make_estimate_fn(mods, patch_cfg, grid, cam, densify, rho_prime, device)

    def estimate(img_pairs):
        return {k: v[:, None] for k, v in fn(_as_tensor(img_pairs)).items()}

    return estimate
