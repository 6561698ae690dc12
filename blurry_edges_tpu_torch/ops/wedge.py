"""Wedge rasterizer and closed-form ridge color solver, in plain PyTorch.

The port of ``blurry_edges_tpu/ops/wedge.py``: each R x R patch carries two
wedges (corner (x, y) in [-1, 1]^2, base angle theta, opening phi) and a blur
level eta per wedge. These functions turn parameters into signed-distance
fields, soft memberships, boundary maps and depth masks, and solve the
per-patch 3-color ridge regression with a Cayley-Hamilton 3x3 inverse.
Arbitrary leading batch dimensions; float32 throughout.

``render_pair_grid`` and ``depth_from_etas`` compose them over a patch grid:
shared wedge geometry with per-image blur levels, a joint ridge color solve
across the image pair, and the DfD depth of each patch (reference
global_training.py:62-90), in the grid-leading layouts params
(B, Hp, Wp, k), fields (B, [2,] Hp, Wp, R, R[, C]). They are the plain
render's core (``ops/wedge_cuda.py::wedge_render_plain``).

Parity target: reference utils/postprocessing_loss.py:27-117.
"""

from __future__ import annotations

import math

import torch

from ..config import PatchConfig
from .dfd import DfDSolver

TWO_PI = 2.0 * math.pi


def make_patch_grid(R: int, dtype=torch.float32, device=None):
    """Patch-frame coordinates (x along columns, y along rows, both in
    [-1, 1]); returns (x, y), each (R, R)."""
    coords = torch.linspace(-1.0, 1.0, R, dtype=dtype, device=device)
    y, x = torch.meshgrid(coords, coords, indexing="ij")
    return x, y


def _dist_edge(x, y, cx, cy, angle):
    """Signed distance to the line through (cx, cy) with direction ``angle``."""
    return -torch.sin(angle) * (x - cx) + torch.cos(angle) * (y - cy)


def _dist_axial(x, y, cx, cy, angle):
    """Signed coordinate along the ray direction."""
    return torch.cos(angle) * (x - cx) + torch.sin(angle) * (y - cy)


def _soft_back_extension(d_edge, d_axial, w):
    """Behind the corner (axial < 0) blend the axial distance into the edge
    distance, keeping the sign of the edge side."""
    sgn = torch.where(d_edge < 0, -1.0, 1.0)
    soft = torch.sqrt(d_edge**2 + (d_axial * w) ** 2) * sgn
    return torch.where(d_axial < 0, soft, d_edge)


def _wedge_dists(p, x, y, w):
    """Shared body of params2dists[_flat]: ``p(i)`` selects parameter i
    broadcast against the pixel coordinates ``x``, ``y``."""
    x0, y0, x1, y1 = p(0), p(1), p(2), p(3)
    th1, ph1, th2, ph2 = p(4), p(5), p(6), p(7)
    sgn1 = torch.where(torch.remainder(ph1, TWO_PI) < math.pi, 1.0, -1.0)
    sgn2 = torch.where(torch.remainder(ph2, TWO_PI) < math.pi, 1.0, -1.0)
    th1p = th1 + ph1
    th2p = th2 + ph2

    d11 = _soft_back_extension(_dist_edge(x, y, x0, y0, th1), _dist_axial(x, y, x0, y0, th1), w)
    d12 = _soft_back_extension(_dist_edge(x, y, x0, y0, th1p), _dist_axial(x, y, x0, y0, th1p), w)
    d21 = _soft_back_extension(_dist_edge(x, y, x1, y1, th2), _dist_axial(x, y, x1, y1, th2), w)
    d22 = _soft_back_extension(_dist_edge(x, y, x1, y1, th2p), _dist_axial(x, y, x1, y1, th2p), w)

    # wedge 1 tests its interior with strict inequalities, wedge 2 non-strict
    ind1 = sgn1 * torch.where((sgn1 * d11 > 0) & (sgn1 * d12 < 0), 1.0, -1.0)
    ind2 = sgn2 * torch.where((sgn2 * d21 >= 0) & (sgn2 * d22 <= 0), 1.0, -1.0)
    dist1 = torch.minimum(d11.abs(), d12.abs()) * ind1
    dist2 = torch.minimum(d21.abs(), d22.abs()) * ind2
    return dist1, dist2


def params2dists(params, x, y, w: float = 1.0):
    """Signed distance fields of the two wedges (positive inside).

    params (..., 8) = (x0, y0, x1, y1, theta1, phi1, theta2, phi2);
    x, y: (R, R) -> (..., 2, R, R).
    """
    dist1, dist2 = _wedge_dists(lambda i: params[..., i, None, None], x, y, w)
    return torch.stack([dist1, dist2], dim=-3)


def params2dists_flat(params, xf, yf, w: float = 1.0):
    """params2dists with the pixel axis flattened: params (..., 8),
    xf/yf (N,) -> (dist1, dist2), each (..., N)."""
    return _wedge_dists(lambda i: params[..., i, None], xf, yf, w)


def params2etas(coefs):
    """Blur level eta = 10^(2 erf(c) - 2), in (1e-4, 1)."""
    return 10.0 ** (torch.erf(coefs) * 2.0 - 2.0)


def indicator_flat(d, eta):
    """Gaussian-CDF soft step: d (..., N), eta (...,) -> (..., N)."""
    if eta.dim() < d.dim():
        eta = eta[..., None]
    return 0.5 * (1.0 + torch.erf(d / (math.sqrt(2.0) * eta)))


def dists2indicators(dists, etas):
    """Soft memberships (u0, u1, u2) with u0 + u1 + u2 == 1.

    dists (..., 2, R, R), etas (..., 2) -> (..., 3, R, R).
    """
    h = 0.5 * (1.0 + torch.erf(dists / (math.sqrt(2.0) * etas[..., None, None])))
    h0, h1 = h[..., 0, :, :], h[..., 1, :, :]
    return torch.stack([(1.0 - h0) * (1.0 - h1), h0 * (1.0 - h1), h1], dim=-3)


def boundary_distance_field(dists):
    """Distance to the nearest visible boundary (wedge 2 occludes wedge 1):
    (..., 2, R, R) -> (..., R, R)."""
    d0, d1 = dists[..., 0, :, :], dists[..., 1, :, :]
    return torch.where(d1 >= 0, d1,
                       torch.where(d0.abs() < d1.abs(), d0.abs(), d1.abs()))


def boundary_distance_field_flat(d1, d2):
    """boundary_distance_field on flat fields d1, d2 (..., N) -> (..., N)."""
    return torch.where(d2 >= 0, d2,
                       torch.where(d1.abs() < d2.abs(), d1.abs(), d2.abs()))


def normalized_gaussian(v, delta: float = 0.07):
    """Boundary-proximity bump exp(-v^2 / delta^2)."""
    return torch.exp(-(v**2) / delta**2)


def boundary_map(dists, delta: float = 0.07):
    """Soft boundary map of a patch from its wedge distance fields."""
    return normalized_gaussian(boundary_distance_field(dists), delta)


def depth_masks(dists, hard: bool = False):
    """Per-pixel wedge assignment, int32: 0 background, 1 wedge 1, 2 wedge 2.

    hard=False: the near-boundary band (gaussian > 0.5); hard=True: the
    wedge interiors (dists > 0), as ``--densify w`` uses.
    """
    d0, d1 = dists[..., 0, :, :], dists[..., 1, :, :]
    if hard:
        m1 = (d0 > 0).to(torch.int32)
        m2 = (d1 > 0).to(torch.int32) * 2
        return torch.where(m2 == 2, m2, m1)
    m1 = (normalized_gaussian(d0) > 0.5).to(torch.int32)
    m2 = (normalized_gaussian(d1) > 0.5).to(torch.int32) * 2
    return torch.where((m2 == 2) | (d1 >= 0), m2, m1)


def depth_masks_flat(d1, d2, hard: bool = False):
    """depth_masks on flat fields d1, d2 (..., N) -> int32 (..., N)."""
    if hard:
        m1 = (d1 > 0).to(torch.int32)
        m2 = (d2 > 0).to(torch.int32) * 2
        return torch.where(m2 == 2, m2, m1)
    m1 = (normalized_gaussian(d1) > 0.5).to(torch.int32)
    m2 = (normalized_gaussian(d2) > 0.5).to(torch.int32) * 2
    return torch.where((m2 == 2) | (d2 >= 0), m2, m1)


def _mm3(a, b):
    """(..., I, K) @ (..., K, J) as a multiply-reduce: exact float32 on every
    device, whatever the TF32 matmul setting."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def inverse_3x3(A):
    """Cayley-Hamilton inverse of a batch of 3x3 matrices:
    det = (tr(A)^3 - 3 tr(A) tr(A^2) + 2 tr(A^3)) / 6,
    adj = A^2 - tr(A) A + ((tr(A)^2 - tr(A^2)) / 2) I. No pivoting: callers
    condition A with the ridge term.

    Evaluated in float64 and returned in A's dtype: in float32 the trace
    identities cancel catastrophically when a wedge owns almost no pixel
    (det ~ 2e4 against tr(A)^3 ~ 7e8 for a pair's 882-pixel Gram matrix),
    which costs up to ~2e-3 in the colors.
    """
    dtype, A = A.dtype, A.double()
    trA = A.diagonal(dim1=-2, dim2=-1).sum(-1)
    A2 = _mm3(A, A)
    trA2 = A2.diagonal(dim1=-2, dim2=-1).sum(-1)
    A3 = _mm3(A2, A)
    trA3 = A3.diagonal(dim1=-2, dim2=-1).sum(-1)
    detA = (trA**3 - 3.0 * trA * trA2 + 2.0 * trA3) / 6.0
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    adjA = A2 - trA[..., None, None] * A + ((trA**2 - trA2) / 2.0)[..., None, None] * eye
    return (adjA / detA[..., None, None]).to(dtype)


def solve_colors(wedges, pixels, lambda_ridge: float):
    """Ridge regression for the 3 wedge colors: wedges (..., N, 3) design
    matrix, pixels (..., N, C) -> (A^T A + lambda I)^{-1} A^T y, (..., 3, C)."""
    At = wedges.transpose(-1, -2)
    At_A = _mm3(At, wedges)
    At_y = _mm3(At, pixels)
    ridge = lambda_ridge * torch.eye(3, dtype=wedges.dtype, device=wedges.device)
    return _mm3(inverse_3x3(At_A + ridge), At_y)


def render_patches(wedges, colors):
    """Composite memberships (..., 3, R, R) with colors (..., 3, C) ->
    (..., R, R, C)."""
    return sum(wedges[..., k, :, :, None] * colors[..., k, None, None, :]
               for k in range(3))


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
