"""Photon-limited image pairs from a seed, made on the device.

A scene is a background colour and ``n_shapes`` piecewise-constant shapes
(discs and rotated rectangles), each at its own depth in ``z_range``,
painted far to near. Each image of the pair sees every shape blurred by
the Gaussian of the thin-lens defocus at its aperture (rho_1 or rho_2) and
the shape's depth, so the two images differ in blur as the camera's do.
Then the reference's test protocol (Blurry-Edges ``utils/args.py:70-73``):
the clean image scaled to alpha ~ U[alpha_range] photons, Poisson shot
noise plus Gaussian read noise of sigma_read, clipped to [0, alpha],
rounded, and divided by alpha. Calls nothing of the program."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def blur_sigma_px(z, rho: float, cam: dict, mag: float):
    """Defocus blur in pixels of a point at depth z through an aperture of
    optical power rho (the reference's camera model)."""
    return torch.abs((1.0 / z - rho) * cam["s"] + 1.0) * cam["sigma_cam"] / (cam["pixel_pitch"] * mag)


def _gauss_blur(masks, sigmas, half: int):
    """Separable Gaussian blur of (n, H, W) masks, each with its own sigma
    (n,), replicate padding; support 2 * half + 1."""
    t = torch.arange(-half, half + 1, dtype=masks.dtype, device=masks.device)
    k = torch.exp(-0.5 * (t[None] / sigmas.clamp(min=1e-3)[:, None]) ** 2)
    k = k / k.sum(1, keepdim=True)
    n = masks.shape[0]
    x = F.pad(masks[None], (half, half, half, half), mode="replicate")
    x = F.conv2d(x, k[:, None, None, :], groups=n)
    return F.conv2d(x, k[:, None, :, None], groups=n)[0]


def clean_pairs(g: torch.Generator, n: int, H: int, scene: dict, cam: dict, mag: float, device):
    """(n, 2, H, W, 3) clean pairs in [0, 255]."""
    S = scene["n_shapes"]
    z0, z1 = scene["z_range"]

    def rand(*shape):
        return torch.rand(shape, generator=g, device=device)

    yy, xx = torch.meshgrid(torch.arange(H, device=device, dtype=torch.float32),
                            torch.arange(H, device=device, dtype=torch.float32), indexing="ij")
    out = torch.empty((n, 2, H, H, 3), device=device)
    for i in range(n):
        z = z0 + (z1 - z0) * rand(S)
        z = torch.sort(z, descending=True).values               # far to near
        cx, cy = rand(S) * H, rand(S) * H
        size = H * (0.05 + 0.25 * rand(S))
        ang = rand(S) * math.pi
        disc = rand(S) < 0.5
        dx, dy = xx[None] - cx[:, None, None], yy[None] - cy[:, None, None]
        u = dx * torch.cos(ang)[:, None, None] + dy * torch.sin(ang)[:, None, None]
        v = -dx * torch.sin(ang)[:, None, None] + dy * torch.cos(ang)[:, None, None]
        aspect = (0.3 + 0.7 * rand(S))[:, None, None]
        s = size[:, None, None]
        masks = torch.where(disc[:, None, None], (dx ** 2 + dy ** 2) <= s ** 2,
                            (u.abs() <= s) & (v.abs() <= s * aspect)).float()
        colors = 255.0 * rand(S, 3)
        bg = 255.0 * rand(3)
        for a, rho in enumerate((cam["rho_1"], cam["rho_2"])):
            soft = _gauss_blur(masks, blur_sigma_px(z, rho, cam, mag), scene["blur_half_px"])
            img = bg.expand(H, H, 3).clone()
            for k in range(S):
                img = img * (1.0 - soft[k, ..., None]) + colors[k] * soft[k, ..., None]
            out[i, a] = img
    return out


def photon_noise(g: torch.Generator, clean, alpha, sigma_read: float):
    """clean (n, ...) in [0, 255], alpha (n,) -> the noisy photon counts
    divided by alpha."""
    a = alpha.reshape((-1,) + (1,) * (clean.dim() - 1))
    lam = clean / 255.0 * a
    ny = torch.poisson(lam, generator=g) + sigma_read * torch.randn(
        lam.shape, generator=g, device=lam.device)
    return torch.round(torch.minimum(torch.clamp(ny, min=0.0), a)) / a


def make_pairs(seed: int, n: int, H: int, config: dict, device):
    """``n`` noisy pairs (n, 2, H, W, 3) float32 on ``device``, from ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))
    scene = config["scene"]
    clean = clean_pairs(g, n, H, scene, config["cam"], config["mag"], device)
    a0, a1 = scene["alpha_range"]
    alpha = a0 + (a1 - a0) * torch.rand(n, generator=g, device=device)
    return photon_noise(g, clean, alpha, scene["sigma_read"])
