"""Thin-lens two-aperture defocus optics (the JAX package's ``ops/optics.py``,
reference utils/data_generator.py:16-24).

The PSF is an order-2 generalised Gaussian on a fixed (2K+1)^2 grid with
the outside of its dynamic support k = ceil(3 sigma) masked to zero, which
equals the reference's dynamically sized PSF on integer coordinates. Both
the Gaussian and its square support are separable, so a blur is two 1-D
passes. ``blur_fixed_support`` runs many blurs at once as one depthwise
``F.conv2d``: each (image channel, sigma) pair is a channel with its own
kernel, so the blurs of every shape slot and aperture, or of every depth
key-point and aperture, go in one launch a pass.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ..config import CamConfig
from ..utils.device import float32_precision


def kernel_sigma(z, cam: CamConfig, mag: float):
    """Per-aperture PSF sigma (pixels) at depth z (m):
    |(1/z - rho_i) s + 1| * sigma_cam / (pixel_pitch * mag).

    z: tensor of any shape; returns z.shape + (2,).
    """
    rhos = torch.tensor([cam.rho_1, cam.rho_2], dtype=z.dtype, device=z.device)
    return (torch.abs((1.0 / z[..., None] - rhos) * cam.s + 1.0)
            * cam.sigma_cam / cam.pixel_pitch / mag)


def max_kernel_halfwidth(cam: CamConfig, mag: float, z_range: Tuple[float, float]) -> int:
    """Static upper bound K on the support half-width ceil(3 sigma) over the
    depth range (sigma is monotone in 1/z, so an endpoint attains it)."""
    sig_max = 0.0
    for z in z_range:
        for rho in (cam.rho_1, cam.rho_2):
            sig_max = max(sig_max, abs((1.0 / z - rho) * cam.s + 1.0)
                          * cam.sigma_cam / cam.pixel_pitch / mag)
    return int(math.ceil(3.0 * sig_max))


def _gaussian_1d(sigma, K: int):
    """Masked 1-D Gaussians on the grid [-K, K], unnormalised: sigma (...,)
    -> (..., 2K+1), zero outside |x| <= ceil(3 sigma)."""
    sigma = torch.clamp(sigma, min=1e-6)[..., None]
    k = torch.ceil(sigma * 3.0)
    xs = torch.arange(-K, K + 1, dtype=sigma.dtype, device=sigma.device)
    g = torch.exp(-(xs**2) / (2.0 * sigma**2))
    return torch.where(torch.abs(xs) <= k, g, 0.0)


def gaussian_psf_bank(sigmas, K: int):
    """2-D PSFs of a batch of sigmas, each summing to 1: (B,) ->
    (B, 2K+1, 2K+1)."""
    g1 = _gaussian_1d(sigmas, K)
    psf = g1[:, :, None] * g1[:, None, :]
    return psf / psf.sum(dim=(-2, -1), keepdim=True)


def symmetric_pad(x, K: int):
    """Pad the last two axes by K with the edge pixel repeated (numpy's and
    jnp.pad's ``mode="symmetric"``, scipy.ndimage's ``mode="reflect"``;
    torch's ``reflect`` leaves the edge pixel out). Needs K <= size."""
    H, W = x.shape[-2:]

    def index(n):
        i = torch.arange(-K, n + K, device=x.device)
        return torch.where(i < 0, -1 - i, torch.where(i >= n, 2 * n - 1 - i, i))

    return x[..., index(H), :][..., index(W)]


def blur_fixed_support(img, sigma, K: int):
    """Separable blur with edge-repeating padding: img (N, H, W) with one
    sigma each, sigma (N,) -> (N, H, W). Each 1-D kernel is the masked
    Gaussian normalised to sum 1 (the kernel is symmetric, so scipy's
    convolution equals this correlation). All N blurs run as the channels
    of one depthwise convolution a pass, in float32 (TF32 off)."""
    N, H, W = img.shape
    g = _gaussian_1d(sigma.to(img.dtype), K)
    g = g / g.sum(-1, keepdim=True)                              # (N, 2K+1)
    x = symmetric_pad(img, K)[None]                              # (1, N, H+2K, W+2K)
    with float32_precision():
        x = F.conv2d(x, g[:, None, :, None], groups=N)           # rows
        x = F.conv2d(x, g[:, None, None, :], groups=N)           # columns
    return x[0]
