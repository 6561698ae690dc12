"""The two wedge kernels: wrappers, launch counts and plain versions.

``wedge_colors`` replaces the TPU kernel ``ops/wedge_pallas.py::
wedge_colors_pallas`` (CUDA source ``csrc/wedge_colors.cu``) and
``wedge_render`` replaces ``wedge_render_pallas`` (``csrc/wedge_render.cu``).

A wrapper given CUDA tensors checks them and launches its kernel on the
current stream, or raises; it never synchronises. Given CPU tensors it runs
its plain PyTorch version (``wedge_colors_plain``, ``wedge_render_plain``),
which is also the oracle the kernels are held against on the card.
"""

from __future__ import annotations

import torch

from ..config import PatchConfig
from ..utils.trace import span
from ._launch import check, device_type, raise_on, stream
from .dfd import DfDSolver
from .params import wrap_local_params
from .wedge import (boundary_map, depth_from_etas, dists2indicators,
                    indicator_flat, inverse_3x3, params2dists_flat, params2etas,
                    render_pair_grid, render_patches)

_LAUNCHES = {"wedge_colors": 0, "wedge_render": 0}


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel name."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


# --------------------------------------------------------------- colors


def wedge_colors_plain(params, pixels, patch_cfg: PatchConfig):
    """Plain PyTorch per-patch color solve (the flat Gram path of the JAX
    package's ``solve_patch_colors``): params (P, 10) raw local-stage outputs
    (angles wrapped here), pixels (P, R, R, 3) -> colors (P, 3 wedges, 3)."""
    R, w = patch_cfg.R, patch_cfg.w
    params = wrap_local_params(params)
    coords = torch.linspace(-1.0, 1.0, R, dtype=params.dtype, device=params.device)
    yg, xg = torch.meshgrid(coords, coords, indexing="ij")
    d1, d2 = params2dists_flat(params[..., :8], xg.reshape(-1), yg.reshape(-1), w)
    etas = params2etas(params[..., 8:])
    h1 = indicator_flat(d1, etas[..., 0])
    h2 = indicator_flat(d2, etas[..., 1])
    U = torch.stack([(1.0 - h1) * (1.0 - h2), h1 * (1.0 - h2), h2], dim=-2)  # (P,3,N)
    yv = pixels.reshape(pixels.shape[0], R * R, 3).transpose(-1, -2)          # (P,3,N)
    At_A = (U[:, :, None, :] * U[:, None, :, :]).sum(-1)                      # (P,3,3)
    At_y = (U[:, :, None, :] * yv[:, None, :, :]).sum(-1)                     # (P,3k,3c)
    ridge = patch_cfg.lambda_ridge * torch.eye(3, dtype=params.dtype, device=params.device)
    inv = inverse_3x3(At_A + ridge)
    return (inv[:, :, :, None] * At_y[:, None, :, :]).sum(-2)


def wedge_colors(params, pixels, patch_cfg: PatchConfig):
    """Per-patch ridge colors: params (P, 10) raw local-stage outputs,
    pixels (P, R, R, 3) -> (P, 3, 3) float32. CUDA tensors: the
    wedge_colors kernel; CPU tensors: ``wedge_colors_plain``."""
    with span("wedge_colors"):
        if device_type(params, pixels) == "cpu":
            return wedge_colors_plain(params, pixels, patch_cfg)
        R = patch_cfg.R
        P = params.shape[0]
        check("params", params, (P, 10))
        check("pixels", pixels, (P, R, R, 3))
        from ._build import load_library

        lib = load_library().cdll
        colors = torch.empty((P, 3, 3), dtype=torch.float32, device=params.device)
        rc = lib.wedge_colors_launch(params.data_ptr(), pixels.data_ptr(),
                                     colors.data_ptr(), P, R, patch_cfg.w,
                                     patch_cfg.lambda_ridge,
                                     stream(params))
        raise_on(rc, "wedge_colors")
        _LAUNCHES["wedge_colors"] += 1
        return colors


# --------------------------------------------------------------- render


def wedge_render_plain(xy_angles, etas, img_patches, patch_cfg: PatchConfig,
                       dfd: DfDSolver, rho_prime: float, hard_mask: bool):
    """Plain PyTorch full render (the JAX ``render_full``): pair patches with
    a joint color solve, sharpened (eta = 1e-4) and refocused (eta =
    depth2sigma at rho_prime) renders, boundary map, DfD depth and mask.

    xy_angles (B, Hp, Wp, 8); etas (B, Hp, Wp, 4);
    img_patches (B, 2, Hp, Wp, R, R, 3).
    """
    patches, _, colors, dists = render_pair_grid(xy_angles, etas, img_patches, patch_cfg)
    local_bndry = boundary_map(dists)
    depth_map, depth_mask, d1, d2 = depth_from_etas(etas, dists, dfd, hard_mask=hard_mask)

    wedges_shpd = dists2indicators(dists, torch.full_like(etas[..., :2], 1e-4))
    patches_shpd = render_patches(wedges_shpd, colors)

    any1 = (depth_mask == 1).sum(dim=(-2, -1)) > 0          # (B, Hp, Wp)
    any2 = (depth_mask == 2).sum(dim=(-2, -1)) > 0
    sig1 = torch.where(any1, dfd.depth2sigma(d1, rho_prime), 1e-4)
    sig2 = torch.where(any2, dfd.depth2sigma(d2, rho_prime), 1e-4)
    wedges_refoc = dists2indicators(dists, torch.stack([sig1, sig2], dim=-1))
    patches_refoc = render_patches(wedges_refoc, colors)

    return dict(patches=patches, patches_shpd=patches_shpd,
                patches_refoc=patches_refoc, local_bndry=local_bndry,
                depth_map=depth_map, depth_mask=depth_mask)


def wedge_render(xy_angles, etas, img_patches, patch_cfg: PatchConfig,
                 dfd: DfDSolver, rho_prime: float, hard_mask: bool):
    """The full render, same arguments and result as ``wedge_render_plain``.
    CUDA tensors: the wedge_render kernel, which writes every output straight
    into this layout; CPU tensors: ``wedge_render_plain``."""
    with span("wedge_render"):
        if device_type(xy_angles, etas, img_patches) == "cpu":
            return wedge_render_plain(xy_angles, etas, img_patches, patch_cfg, dfd,
                                      rho_prime, hard_mask)
        R = patch_cfg.R
        B, Hp, Wp = xy_angles.shape[:3]
        check("xy_angles", xy_angles, (B, Hp, Wp, 8))
        check("etas", etas, (B, Hp, Wp, 4))
        check("img_patches", img_patches, (B, 2, Hp, Wp, R, R, 3))
        from ._build import load_library

        lib = load_library().cdll
        dev = xy_angles.device

        def empty(*shape, dtype=torch.float32):
            return torch.empty(shape, dtype=dtype, device=dev)

        out = dict(patches=empty(B, 2, Hp, Wp, R, R, 3),
                   patches_shpd=empty(B, Hp, Wp, R, R, 3),
                   patches_refoc=empty(B, Hp, Wp, R, R, 3),
                   local_bndry=empty(B, Hp, Wp, R, R),
                   depth_map=empty(B, Hp, Wp, R, R),
                   depth_mask=empty(B, Hp, Wp, R, R, dtype=torch.int32))
        delta = 0.07  # boundary-map width (ops.wedge.normalized_gaussian)
        rc = lib.wedge_render_launch(
            xy_angles.data_ptr(), etas.data_ptr(), img_patches.data_ptr(),
            out["patches"].data_ptr(), out["patches_shpd"].data_ptr(),
            out["patches_refoc"].data_ptr(), out["local_bndry"].data_ptr(),
            out["depth_map"].data_ptr(), out["depth_mask"].data_ptr(),
            B, Hp * Wp, R, patch_cfg.w, patch_cfg.lambda_ridge, int(hard_mask),
            rho_prime, delta**2, dfd.numerator, dfd.denominator_constant,
            dfd.denominator_factor, dfd.denominator_factor_root, dfd.intercept,
            dfd.s, stream(xy_angles))
        raise_on(rc, "wedge_render")
        _LAUNCHES["wedge_render"] += 1
        return out
