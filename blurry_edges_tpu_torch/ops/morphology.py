"""Binary morphology: dilation and the city-block distance to a boundary set
(the JAX package's ``ops/morphology.py``; reference
train_val_data_generator.py:77-78, 98-109, 238-250, with scipy's 4- and
8-connected structuring elements).

Dilations are max-pools with the footprint. ``distance_transform_l1`` is
the separable min-plus transform, each 1-D pass as a running minimum of
f(j') - j' (forward) and f(j') + j' (reversed): exact on integer
distances. ``distance_transform_l1_bfs``, the iterated 4-connected
dilation, is its plain oracle.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _pool(mask, k: int, pad: int):
    H, W = mask.shape[-2:]
    x = mask.reshape((-1, 1, H, W)).to(torch.float32)
    return (F.max_pool2d(x, k, 1, pad) > 0).reshape(mask.shape)


def dilate_cross(mask):
    """One 4-connected dilation: mask (..., H, W) bool."""
    m = mask
    out = m.clone()
    out[..., :-1, :] |= m[..., 1:, :]
    out[..., 1:, :] |= m[..., :-1, :]
    out[..., :, :-1] |= m[..., :, 1:]
    out[..., :, 1:] |= m[..., :, :-1]
    return out


def dilate_full(mask):
    """One 8-connected dilation (a 3x3 square): mask (..., H, W) bool."""
    return _pool(mask, 3, 1)


def dilate_full_n(mask, n: int):
    """n 8-connected dilations, as one (2n+1)^2 square max-pool."""
    return _pool(mask, 2 * n + 1, n)


def _minplus_1d(f, dim: int):
    """out[j] = min_j' (f[j'] + |j - j'|) along ``dim``."""
    n = f.shape[dim]
    shape = [1] * f.dim()
    shape[dim] = n
    i = torch.arange(n, dtype=f.dtype, device=f.device).reshape(shape)
    fwd = torch.cummin(f - i, dim).values + i
    bwd = torch.flip(torch.cummin(torch.flip(f + i, (dim,)), dim).values, (dim,)) - i
    return torch.minimum(fwd, bwd)


def distance_transform_l1(boundary_mask):
    """City-block distance to the set ``boundary_mask`` (..., H, W) bool ->
    float32: 0 on the set, k on ring k; a mask with no pixel set gives all
    ones (the reference's ``dist_blank *= -1`` fallback)."""
    H, W = boundary_mask.shape[-2:]
    inf = float(H + W + 2)
    f = torch.where(boundary_mask, 0.0, inf)
    dist = _minplus_1d(_minplus_1d(f, -1), -2)
    has_any = boundary_mask.flatten(-2).any(-1)[..., None, None]
    return torch.where(has_any, dist, 1.0)


def distance_transform_l1_bfs(boundary_mask, max_iters: int):
    """The iterated 4-connected dilation (the reference's own loop), for a
    single mask (H, W): the oracle of ``distance_transform_l1``."""
    dist = torch.where(boundary_mask, 0.0, -1.0)
    front = boundary_mask
    k = 0
    while bool((dist == -1.0).any()) and k < max_iters:
        front = dilate_cross(front)
        dist = torch.where(front & (dist == -1.0), k + 1.0, dist)
        k += 1
    return dist if bool(boundary_mask.any()) else torch.ones_like(dist)
