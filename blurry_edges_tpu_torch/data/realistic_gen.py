"""Realistic-texture test sets (the JAX package's ``data/realistic_gen.py``,
its procedural source; reference test_data_generator.py:10-176).

A test pair is a textured foreground ellipse over a textured background,
each on its own random depth plane, rendered through layered defocus: for
each of 151 depth key-points of a layer, the layer blurred with that
depth's sigma of each aperture, blended by per-pixel linear weights, the
foreground composited with its blurred mask; then the photon noise of the
train/val generator. The draws of a sample (``draw_sample``, from a
``torch.Generator``) are apart from the work (``synth_from_draws``); a
layer's 151 x 2 blurs of its 3 color channels and its mask run as the
channels of one depthwise convolution a pass.

``noise_texture`` upsamples by the cubic resize of ``jax.image.resize``
(Keys' kernel with a = -0.5, half-pixel centres, taps outside the input
dropped and the rest renormalised), built here as two weight matrices;
``F.interpolate(mode="bicubic")`` (a = -0.75, clamped edges) computes
another function.

The reference's MS-COCO/Painting source (``--coco``) is not ported: it
needs MS-COCO's ``instances_val2017.json`` and ``val2017/`` images, a
Painting folder and OpenCV, none of which the repository holds.
"""

from __future__ import annotations

import functools
import math
import os

import numpy as np
import torch

from ..config import CamConfig
from ..ops import optics
from ..utils.device import float32_precision, resolve_device
from .shapes_gen import add_photon_noise

TEXTURE_OCTAVES = ((6, 0.6), (16, 0.3), (48, 0.1))   # (resolution, amplitude)


def _linspace(start, stop, num: int):
    """jnp.linspace's arithmetic: start * (1 - t) + stop * t, t = i / (num -
    1), and stop itself last; start and stop are 0-d tensors."""
    t = torch.arange(num - 1, dtype=start.dtype, device=start.device) / (num - 1)
    return torch.cat([start * (1 - t) + stop * t, stop[None]])


def render_layer(depth_map, key_pts, img_sharp, mask, cam: CamConfig, mag: float, K: int):
    """Depth-varying defocus of one layer (reference test_data_generator.py:
    87-110): every descending depth key-point's blur of the sharp layer
    with that depth's sigma of each aperture, accumulated in key-point
    order with per-pixel linear interpolation weights.

    depth_map (H, W); key_pts (n,) descending; img_sharp (H, W, 3); mask
    (H, W) bool or None. Returns (img (2, H, W, 3), mask (2, H, W) clipped
    to [0, 1], or None)."""
    H, W = depth_map.shape
    n = key_pts.shape[0]
    diff = key_pts[1] - key_pts[0]                                     # negative
    chans = img_sharp.permute(2, 0, 1)                                 # (3, H, W)
    if mask is not None:
        chans = torch.cat([chans, mask.float()[None]])
    C = chans.shape[0]
    sigmas = optics.kernel_sigma(key_pts, cam, mag)                    # (n, 2)
    jobs = chans[None, None].expand(n, 2, C, H, W).reshape(-1, H, W)
    blurred = optics.blur_fixed_support(
        jobs, sigmas[:, :, None].expand(n, 2, C).reshape(-1), K).reshape(n, 2, C, H, W)

    d = key_pts[:, None, None]
    m_last = ((depth_map <= d - diff) & (depth_map > d)).float()
    m_next = ((depth_map <= d) & (depth_map > d + diff)).float()
    below, above = (depth_map > d).float(), (depth_map <= d).float()
    up = (depth_map - d - diff) / (-diff) * m_next
    down = (d - diff - depth_map) / (-diff) * m_last
    w = torch.cat([(below + up)[:1], (down + up)[1:-1], (down + above)[-1:]])   # (n, H, W)

    img = torch.zeros((2, H, W, 3), device=depth_map.device)
    acc_mask = torch.zeros((2, H, W), device=depth_map.device)
    for j in range(n):
        img = img + blurred[j, :, :3].permute(0, 2, 3, 1) * w[j][None, :, :, None]
        if mask is not None:
            acc_mask = acc_mask + blurred[j, :, 3] * w[j][None]
    return img, (torch.clamp(acc_mask, 0.0, 1.0) if mask is not None else None)


def render_image(depth_bkgd, depth_frgd, frgd_mask, bkgd_obj, frgd_obj, cam: CamConfig,
                 mag: float, K: int, n_interval: int = 150):
    """The two-layer composite (reference test_data_generator.py:112-121):
    the foreground's key-points span its depths inside the mask."""
    bk_pts = _linspace(depth_bkgd.max(), depth_bkgd.min(), n_interval + 1)
    fg = depth_frgd[frgd_mask]
    fg_pts = _linspace(fg.max(), fg.min(), n_interval + 1)
    img_bk, _ = render_layer(depth_bkgd, bk_pts, bkgd_obj, None, cam, mag, K)
    img_fg, mask_fg = render_layer(depth_frgd, fg_pts, frgd_obj, frgd_mask, cam, mag, K)
    return img_bk * (1.0 - mask_fg[..., None]) + img_fg


def _grid(H: int, W: int, device):
    return torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                          torch.arange(W, dtype=torch.float32, device=device), indexing="ij")


def planar_depths(rel, angles, H: int, W: int, z_lo: float, z_hi: float):
    """Background and foreground depth planes (reference
    test_data_generator.py:123-133) from rel (4,) descending relative key
    depths [bg1, bg2, fg1, fg2] and two tilt angles (2,): (d_bk, d_fg,
    d_bk_n, d_fg_n), each (H, W), metric and normalised."""
    ys, xs = _grid(H, W, rel.device)
    ox, oy = W // 2, H // 2
    modi = (-torch.sin(angles)[:, None, None] * (xs - ox)[None]
            + torch.cos(angles)[:, None, None] * (ys - oy)[None])

    def norm(m, hi, lo):
        return (m - m.min()) / (m.max() - m.min()) * (hi - lo) + lo

    d_bk_n = norm(modi[0], rel[0], rel[1])
    d_fg_n = norm(modi[1], rel[2], rel[3])
    real = lambda dn: (z_hi - z_lo) * dn + z_lo                      # noqa: E731
    return real(d_bk_n), real(d_fg_n), d_bk_n, d_fg_n


@functools.lru_cache(maxsize=16)
def cubic_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 weights of ``jax.image.resize(..., "bicubic")``
    along one axis, as jax/_src/image/scale.py computes them in float32:
    Keys' cubic (a = -0.5) at half-pixel sample positions (its support
    widened by n_in / n_out when downsampling), each output's weights
    renormalised to sum 1, outputs outside the input zeroed."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))       # widened when downsampling (antialias)
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.0) - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = ((f32(1.5) * x - f32(2.5)) * x) * x + f32(1.0)
    w = np.where(x >= 1.0, ((f32(-0.5) * x + f32(2.5)) * x - f32(4.0)) * x + f32(2.0), w)
    w = np.where(x >= 2.0, f32(0.0), w).astype(f32)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def cubic_resize(img, H: int, W: int):
    """(h, w, C) -> (H, W, C) by ``cubic_resize_matrix`` on both axes, as
    two float32 matrix products."""
    h, w, _ = img.shape
    mh = torch.from_numpy(cubic_resize_matrix(h, H)).to(img.device)
    mw = torch.from_numpy(cubic_resize_matrix(w, W)).to(img.device)
    with float32_precision():
        out = mh.T @ img.permute(2, 0, 1) @ mw                           # (C, H, W)
    return out.permute(1, 2, 0)


def noise_texture(lows, H: int, W: int):
    """Band-limited texture in [0, 255] from three octaves of uniform noise
    ``lows`` ((6, 6, 3), (16, 16, 3), (48, 48, 3)), each cubic-upsampled."""
    out = torch.zeros((H, W, 3), device=lows[0].device)
    for low, (_, amp) in zip(lows, TEXTURE_OCTAVES):
        out = out + amp * cubic_resize(low, H, W)
    out = out - out.min()
    return out / out.max() * 255.0


def ellipse_mask(c, ab, th, H: int, W: int):
    """The ellipse of centre c (2,) and half-axes ab (2,), both as fractions
    of (W, H), rotated by th: the procedural stand-in for a large
    single-component COCO instance mask."""
    ys, xs = _grid(H, W, c.device)
    wh = torch.tensor([W, H], dtype=torch.float32, device=c.device)
    c, ab = c * wh, ab * wh
    u = torch.cos(th) * (xs - c[0]) + torch.sin(th) * (ys - c[1])
    v = -torch.sin(th) * (xs - c[0]) + torch.cos(th) * (ys - c[1])
    return (u / ab[0]) ** 2 + (v / ab[1]) ** 2 <= 1.0


def draw_sample(g: torch.Generator) -> dict:
    """One sample's draws on ``g``'s device, in the JAX package's ranges:
    the ellipse's c in [0.35, 0.65)^2, ab in [0.22, 0.42)^2, th in [0, pi);
    the textures' uniform lows; the relative depths (4,) descending and
    two angles in [0, 2 pi)."""
    dev = g.device
    u = lambda *shape: torch.rand(shape, generator=g, device=dev)     # noqa: E731
    return dict(c=u(2) * 0.3 + 0.35, ab=u(2) * 0.2 + 0.22, th=u() * math.pi,
                fg_lows=[u(r, r, 3) for r, _ in TEXTURE_OCTAVES],
                bk_lows=[u(r, r, 3) for r, _ in TEXTURE_OCTAVES],
                rel=torch.sort(u(4), descending=True).values,
                angles=u(2) * (2 * math.pi))


def synth_from_draws(draws: dict, H: int, W: int, z_lo: float, z_hi: float,
                     cam: CamConfig, mag: float, K: int, n_interval: int = 150):
    """One procedural test sample from its draws, on their device: (img
    (2, H, W, 3) in [0, 255], depth (H, W))."""
    frgd_mask = ellipse_mask(draws["c"], draws["ab"], draws["th"], H, W)
    frgd_obj = noise_texture(draws["fg_lows"], H, W) * frgd_mask[..., None]
    bkgd_obj = noise_texture(draws["bk_lows"], H, W)
    d_bk, d_fg, d_bk_n, d_fg_n = planar_depths(draws["rel"], draws["angles"], H, W, z_lo, z_hi)
    depth = (z_hi - z_lo) * torch.where(frgd_mask, d_fg_n, d_bk_n) + z_lo
    img = render_image(d_bk, d_fg, frgd_mask, bkgd_obj, frgd_obj, cam, mag, K, n_interval)
    return img, depth


class SyntheticRealisticDataGenerator:
    """Writes a test set in the reference's layout (reference
    test_data_generator.py:138-164): images_gt.npy and images_ny.npy (n, 2,
    H, W, 3), depth_maps.npy (n, H, W), alphas.npy (n,), float32, the
    arrays through ``open_memmap``. ``big`` takes ``--big_img_size``.
    Sample draws come from a CPU ``torch.Generator`` (the same scenes on
    every device), the alphas and the noise from one on ``device``."""

    def __init__(self, args, big: bool = False, source: str = "synthetic",
                 n_interval: int = 150, seed: int = 1869, device="cuda"):
        if source == "coco":
            raise NotImplementedError(
                f"--coco is not ported: it needs MS-COCO's annotations and images "
                f"({args.frgd_path}instances_val2017.json, {args.frgd_path}val2017/), a "
                f"Painting folder ({args.bkgd_path}) and OpenCV; the procedural source is "
                f"the default")
        self.device = resolve_device(device)
        self.args = args
        self.H, self.W = args.big_img_size if big else args.img_size
        self.cam = CamConfig(**args.cam_params)
        self.mag = args.mag
        self.z_lo, self.z_hi = args.Z_range
        self.num_sample = args.num_sample_test
        self.n_interval = n_interval
        self.K = optics.max_kernel_halfwidth(self.cam, self.mag, (self.z_lo, self.z_hi))
        self.scene_gen = torch.Generator().manual_seed(seed)
        self.noise_gen = torch.Generator(device=self.device).manual_seed(seed)

    def generate_synthetic_data(self) -> None:
        a = self.args
        os.makedirs(a.data_path, exist_ok=True)
        H, W, n = self.H, self.W, self.num_sample
        mm = lambda name, shape: np.lib.format.open_memmap(                # noqa: E731
            os.path.join(a.data_path, f"{name}.npy"), mode="w+", dtype=np.float32, shape=shape)
        images_gt, images_ny = mm("images_gt", (n, 2, H, W, 3)), mm("images_ny", (n, 2, H, W, 3))
        depth_maps = mm("depth_maps", (n, H, W))
        alphas = (torch.rand(n, generator=self.noise_gen, device=self.device)
                  * float(a.alpha[1] - a.alpha[0]) + float(a.alpha[0]))
        for i in range(n):
            draws = draw_sample(self.scene_gen)
            draws = {k: ([t.to(self.device) for t in v] if isinstance(v, list)
                         else v.to(self.device)) for k, v in draws.items()}
            img, depth = synth_from_draws(draws, H, W, self.z_lo, self.z_hi, self.cam,
                                          self.mag, self.K, self.n_interval)
            gt, ny = add_photon_noise(img[None], alphas[i:i + 1], a.sigma, self.noise_gen)
            images_gt[i], images_ny[i] = gt[0].cpu().numpy(), ny[0].cpu().numpy()
            depth_maps[i] = depth.cpu().numpy()
        for arr in (images_gt, images_ny, depth_maps):
            arr.flush()
        np.save(os.path.join(a.data_path, "alphas.npy"), alphas.cpu().numpy())
