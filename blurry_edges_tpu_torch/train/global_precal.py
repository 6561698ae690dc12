"""Local tokens for the global stage: unfold each image pair into patches,
run the local CNN, wrap angles, solve each patch's wedge colors on its noisy
pixels and normalize to 19 features (reference global_data_pre_cal.py:38-50).

Only the per-pair chain that inference uses is ported; the precal harness
that writes params_src_*.npy is not.
"""

from __future__ import annotations

from ..config import GridConfig, PatchConfig
from ..models.local_stage import LocalStage
from ..ops.params import normalize_token_features, wrap_local_params
from ..ops.patchify import unfold
from ..ops.wedge_cuda import wedge_colors


def solve_patch_colors(params, patch_pixels, patch_cfg: PatchConfig):
    """Per-patch ridge colors: params (..., 10), patch_pixels (..., R, R, 3)
    -> (..., 3, 3). CUDA tensors go through the wedge_colors kernel, CPU
    tensors through its plain version."""
    lead = params.shape[:-1]
    R = patch_cfg.R
    colors = wedge_colors(params.reshape(-1, 10).contiguous(),
                          patch_pixels.reshape(-1, R, R, 3).contiguous(),
                          patch_cfg)
    return colors.reshape(lead + (3, 3))


def local_tokens(model: LocalStage, img_pairs, patch_cfg: PatchConfig,
                 grid: GridConfig):
    """Image pairs (B, 2, H, W, 3), alpha-normalized -> normalized tokens
    (B, 2, L, 19) and wrapped raw params (B, 2, L, 10), L = Hp * Wp."""
    B = img_pairs.shape[0]
    L, R = grid.num_tokens, grid.R
    patches = unfold(img_pairs.reshape((B * 2,) + img_pairs.shape[2:]),
                     R, grid.stride)                         # (2B, Hp, Wp, R, R, 3)
    flat = patches.reshape(B * 2 * L, R, R, 3)
    # a bfloat16 CNN's output is cast back here: the colors and tokens are
    # float32 (the JAX package's global_precal.py:108)
    params = wrap_local_params(model(flat).float())          # (2BL, 10)
    colors = solve_patch_colors(params, flat, patch_cfg)     # (2BL, 3, 3)
    tokens = normalize_token_features(params, colors)
    return tokens.reshape(B, 2, L, 19), params.reshape(B, 2, L, 10)
