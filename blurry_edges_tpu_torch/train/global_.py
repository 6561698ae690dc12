"""The global stage's patch-grid render: shared wedge geometry with per-image
blur levels, a joint ridge color solve across the image pair, and the DfD
depth of each patch (reference global_training.py:62-90).

Only the parts the inference path uses are ported; the training loss is not.
Layouts are grid-leading: params (B, Hp, Wp, k), fields
(B, [2,] Hp, Wp, R, R[, C]).
"""

from __future__ import annotations

import torch

from ..config import PatchConfig
from ..ops.dfd import DfDSolver
from ..ops.wedge import (depth_masks, dists2indicators, make_patch_grid,
                         params2dists, render_patches, solve_colors)


def render_pair_grid(xy_angles, etas, img_patches, patch_cfg: PatchConfig):
    """xy_angles (B, Hp, Wp, 8); etas (B, Hp, Wp, 4) ordered (img1 wedge1,
    img1 wedge2, img2 wedge1, img2 wedge2); img_patches (B, 2, Hp, Wp, R, R, 3).

    Returns (patches (B,2,Hp,Wp,R,R,3), wedges_pair (B,2,Hp,Wp,3,R,R),
    colors (B,Hp,Wp,3,3), dists (B,Hp,Wp,2,R,R)).
    """
    R = patch_cfg.R
    x, y = make_patch_grid(R, xy_angles.dtype, xy_angles.device)
    dists = params2dists(xy_angles, x, y, patch_cfg.w)
    w1 = dists2indicators(dists, etas[..., 0:2])
    w2 = dists2indicators(dists, etas[..., 2:4])
    wedges_pair = torch.stack([w1, w2], dim=1)             # (B,2,Hp,Wp,3,R,R)

    # joint ridge solve: the design matrix stacks both images' pixels
    A = torch.movedim(wedges_pair, -3, -1)                 # (B,2,Hp,Wp,R,R,3)
    A = torch.movedim(A, 1, 3)                             # (B,Hp,Wp,2,R,R,3)
    A = A.reshape(A.shape[:3] + (2 * R * R, 3))
    yv = torch.movedim(img_patches, 1, 3).reshape(A.shape[:3] + (2 * R * R, 3))
    colors = solve_colors(A, yv, patch_cfg.lambda_ridge)   # (B,Hp,Wp,3,3)

    patches = render_patches(wedges_pair, colors[:, None])  # (B,2,Hp,Wp,R,R,3)
    return patches, wedges_pair, colors, dists


def depth_from_etas(etas, dists, dfd: DfDSolver, hard_mask: bool = False):
    """Per-patch DfD depth map and wedge-assignment mask.

    Returns (depth (B,Hp,Wp,R,R), mask int32 (B,Hp,Wp,R,R), d1, d2 (B,Hp,Wp))."""
    d1 = dfd.etas2depth(etas[..., 0], etas[..., 2])
    d2 = dfd.etas2depth(etas[..., 1], etas[..., 3])
    mask = depth_masks(dists, hard=hard_mask)
    depth = torch.where(mask == 1, d1[..., None, None],
                        torch.where(mask == 2, d2[..., None, None], 0.0))
    return depth, mask, d1, d2
