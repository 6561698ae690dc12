"""Synthetic basic-shape train/val data (the JAX package's
``data/shapes_gen.py``; reference train_val_data_generator.py:7-297).

A scene is up to 25 shape slots (circle, oriented box or triangle, each
with a color and a depth) composited in painter's order over a colored
background, blurred per slot by the defocus of each aperture. The work is
split in two:

- ``draw_shapes``: the nine draws of a batch of scenes (the JAX package's
  shapes_gen.py:149-164), from a ``torch.Generator``;
- ``synthesize_from_draws``: everything else, batched over the scenes on
  their device: SDF rasterization of every slot, all (slot, aperture)
  blurs as the channels of one depthwise convolution, the painter's
  composite over the slots, the boundary distance transform, rounding and
  the Sobel maps.

``SyntheticShapeDataGenerator`` writes the reference's artifacts (names,
shapes, float32) through ``np.lib.format.open_memmap``, a device batch at
a time, and crops the boundary-centred 21x21 patch set with host draws
from ``np.random.RandomState(SEED)``: the stream of the JAX command line's
``np.random.seed(1869)``, so that from the same arrays both packages pick
the same patches.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time

import numpy as np
import torch

from ..config import CamConfig
from ..ops import optics
from ..ops.morphology import dilate_full, dilate_full_n, distance_transform_l1
from ..ops.sobel import image_derivative
from ..utils.device import float32_precision, resolve_device

# the JAX command line's seed of this mode (its cli.py:124)
SEED = 1869


@dataclasses.dataclass(frozen=True)
class ShapeGenConfig:
    """Static generation parameters (reference utils/args.py:18-25)."""

    H: int = 147
    W: int = 147
    R: int = 21
    num_shape_lo: int = 15
    num_shape_hi: int = 26  # exclusive
    z_lo: float = 0.75
    z_hi: float = 1.18
    alpha_lo: float = 180.0
    alpha_hi: float = 200.0
    sigma_read: float = 2.0
    mag: float = 4.0
    cam: CamConfig = CamConfig()

    @property
    def max_shapes(self) -> int:
        return self.num_shape_hi - 1

    @property
    def max_size(self) -> float:
        return max(self.H, self.W) * 0.8  # reference train_val_data_generator.py:54

    @property
    def K(self) -> int:
        return optics.max_kernel_halfwidth(self.cam, self.mag, (self.z_lo, self.z_hi))


def draw_shapes(g: torch.Generator, n: int, cfg: ShapeGenConfig) -> dict:
    """The draws of n scenes on ``g``'s device, each with a leading n:
    num_obj, bg_color (3), shape_type (S), colors (S, 3), z (S, descending:
    painter's back to front), center (S, 2), circle_r (S), rect_whd (S, 3),
    tri_raaa (S, 4), as the JAX package draws them (integer draws in
    [lo, hi), uniform ones scaled to their ranges)."""
    S, dev = cfg.max_shapes, g.device

    def randint(lo, hi, shape):
        return torch.randint(lo, hi, (n,) + shape, generator=g, device=dev)

    def uniform(shape):
        return torch.rand((n,) + shape, generator=g, device=dev)

    ms = cfg.max_size
    return dict(
        num_obj=randint(cfg.num_shape_lo, cfg.num_shape_hi, ()),
        bg_color=randint(0, 255, (3,)).float(),
        shape_type=randint(0, 3, (S,)),
        colors=randint(0, 255, (S, 3)).float(),
        z=torch.sort(uniform((S,)) * (cfg.z_hi - cfg.z_lo) + cfg.z_lo,
                     dim=-1, descending=True).values,
        center=uniform((S, 2)) * torch.tensor([cfg.W, cfg.H], dtype=torch.float32, device=dev),
        circle_r=randint(0, int(ms / 2), (S,)).float(),
        rect_whd=uniform((S, 3)) * torch.tensor([ms, ms, 180.0], dtype=torch.float32, device=dev),
        tri_raaa=uniform((S, 4)) * torch.tensor([ms, 2 * math.pi, 2 * math.pi, 2 * math.pi],
                                                dtype=torch.float32, device=dev))


def _segment_dist(xs, ys, ax, ay, bx, by):
    abx, aby = bx - ax, by - ay
    apx, apy = xs - ax, ys - ay
    t = torch.clamp((apx * abx + apy * aby) / (abx**2 + aby**2 + 1e-12), 0.0, 1.0)
    return torch.hypot(apx - t * abx, apy - t * aby)


def rasterize_slots(shape_type, center, circle_r, rect_whd, tri_raaa, H: int, W: int):
    """Shape slots -> (fill, ring) float 0/1 maps, each (..., H, W) for slot
    parameters with leading (...): fill the interior (cv2 thickness=-1),
    ring the ~1 px outline (thickness=1). Circles take cv2's integer centre
    and radius; a box is cv2.boxPoints((cx, cy), (w, h), angle); a
    triangle has three polar vertices around the centre, floored
    (reference train_val_data_generator.py:58-76)."""
    dev = center.device
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    p = lambda t: t[..., None, None]                           # noqa: E731
    cx, cy = p(center[..., 0]), p(center[..., 1])

    circ = torch.hypot(xs - torch.floor(cx), ys - torch.floor(cy)) - p(torch.floor(circle_r))

    a = p(rect_whd[..., 2]) * (math.pi / 180.0)
    u = torch.cos(a) * (xs - cx) + torch.sin(a) * (ys - cy)
    v = -torch.sin(a) * (xs - cx) + torch.cos(a) * (ys - cy)
    rect = torch.maximum(torch.abs(u) - p(rect_whd[..., 0]) / 2.0,
                         torch.abs(v) - p(rect_whd[..., 1]) / 2.0)

    r, ang = tri_raaa[..., :1], tri_raaa[..., 1:]
    vx = torch.floor(center[..., :1] + r * torch.cos(ang))   # (..., 3)
    vy = torch.floor(center[..., 1:] + r * torch.sin(ang))
    vxs = [p(vx[..., i]) for i in range(3)]
    vys = [p(vy[..., i]) for i in range(3)]

    def edge(i, j):
        return (vxs[j] - vxs[i]) * (ys - vys[i]) - (vys[j] - vys[i]) * (xs - vxs[i])

    s0, s1, s2 = edge(0, 1), edge(1, 2), edge(2, 0)
    tri_in = ((s0 >= 0) & (s1 >= 0) & (s2 >= 0)) | ((s0 <= 0) & (s1 <= 0) & (s2 <= 0))
    tri_d = torch.minimum(torch.minimum(
        _segment_dist(xs, ys, vxs[0], vys[0], vxs[1], vys[1]),
        _segment_dist(xs, ys, vxs[1], vys[1], vxs[2], vys[2])),
        _segment_dist(xs, ys, vxs[2], vys[2], vxs[0], vys[0]))

    t = p(shape_type)
    fill = torch.where(t == 0, circ <= 0.0, torch.where(t == 1, rect <= 0.0, tri_in))
    ring = torch.where(t == 0, torch.abs(circ) <= 0.5,
                       torch.where(t == 1, torch.abs(rect) <= 0.5, tri_d <= 0.5))
    return fill.float(), ring.float()


def synthesize_from_draws(draws: dict, cfg: ShapeGenConfig) -> dict:
    """n scenes from their draws (``draw_shapes``), on the draws' device.

    Returns imgs (n, 2, H, W, 3) in [0, 255] rounded, img_aif (n, H, W, 3)
    in [0, 1], boundary_loc, image_depth, boundary_depth, boundary_dist
    (n, H, W) and deri (n, 2, H, W, 3) (reference
    train_val_data_generator.py:31-116)."""
    H, W = cfg.H, cfg.W
    n, S = draws["shape_type"].shape
    dev = draws["z"].device
    active = (torch.arange(S, device=dev) < draws["num_obj"][:, None]).float()[..., None, None]
    fills, rings = rasterize_slots(draws["shape_type"], draws["center"], draws["circle_r"],
                                   draws["rect_whd"], draws["tri_raaa"], H, W)
    fills, rings = fills * active, rings * active            # (n, S, H, W)

    # every (slot, aperture) blur as one channel of a depthwise convolution
    sigmas = optics.kernel_sigma(draws["z"], cfg.cam, cfg.mag)            # (n, S, 2)
    masks = (fills * 255.0)[:, :, None].expand(n, S, 2, H, W).reshape(n * S * 2, H, W)
    blurred = optics.blur_fixed_support(masks, sigmas.reshape(-1), cfg.K).reshape(n, S, 2, H, W)

    fill_dil = dilate_full(fills > 0)
    ring_dil = dilate_full(rings > 0).float()
    bg = draws["bg_color"][:, None, None, :]
    imgs = torch.ones((n, 2, H, W, 3), device=dev) * bg[:, None]
    aif = torch.ones((n, H, W, 3), device=dev) * bg
    b_loc = torch.zeros((n, H, W), device=dev)
    i_dep = torch.full((n, H, W), cfg.z_hi, device=dev)
    b_dep = torch.zeros((n, H, W), device=dev)
    # painter's order, back to front (reference :77-96)
    for s in range(S):
        fill, ring = fills[:, s], rings[:, s]
        zi = draws["z"][:, s, None, None]
        col = draws["colors"][:, s, None, None, :]
        inside = fill > 0
        i_dep = torch.where(inside, zi, i_dep)
        b_dep = torch.where(fill_dil[:, s], ring_dil[:, s] * zi, b_dep)
        w = (blurred[:, s] / 255.0)[..., None]                              # (n, 2, H, W, 1)
        imgs = w * col[:, None] + (1.0 - w) * imgs
        b_loc = torch.where(inside, ring * 255.0, b_loc)
        aif = torch.where(inside[..., None], col, aif)

    b_dist = distance_transform_l1(b_loc > 0)
    imgs = torch.round(imgs)
    padded = optics.symmetric_pad(imgs.movedim(-1, 2), 1).movedim(2, -1)   # (n, 2, H+2, W+2, 3)
    with float32_precision():
        deri = image_derivative(padded) / 255.0
    return dict(imgs=imgs, img_aif=aif / 255.0, boundary_loc=b_loc, image_depth=i_dep,
                boundary_depth=b_dep, boundary_dist=b_dist, deri=deri)


def add_photon_noise(imgs, alpha, sigma_read: float, g: torch.Generator):
    """Photon-limited imaging (reference train_val_data_generator.py:165-185):
    imgs (n, ..., 3) in [0, 255] scaled to alpha (n,) photons, Poisson shot
    noise plus Gaussian read noise, clipped to [0, alpha] and rounded.
    Returns (img_gt, img_ny)."""
    a = alpha.reshape((-1,) + (1,) * (imgs.dim() - 1))
    img_gt = imgs / 255.0 * a
    ny = (torch.poisson(img_gt, generator=g)
          + sigma_read * torch.randn(img_gt.shape, generator=g, device=img_gt.device))
    return img_gt, torch.round(torch.minimum(torch.clamp(ny, min=0.0), a))


def candidate_mask(boundary_loc, R: int):
    """Patch-centre candidates: the boundary dilated by R // 2 + 1
    (8-connected) with a margin of R // 2 cut off (reference
    train_val_data_generator.py:231-235). (n, H, W) -> bool."""
    half = R // 2
    dil = dilate_full_n(boundary_loc > 0, half + 1)
    margin = torch.zeros(dil.shape[-2:], dtype=torch.bool, device=dil.device)
    margin[half:-half, half:-half] = True
    return dil & margin


class SyntheticShapeDataGenerator:
    """The reference's three phases (generate_synthetic_data, add_noise,
    crop_patch; reference train_val_data_generator.py:118-275) on
    ``device``, ``device_batch`` scenes at a time. Scene draws come from a
    CPU ``torch.Generator`` (the same scenes on every device), noise draws
    from one on ``device``, both seeded with ``SEED``; the patch choice
    from ``np.random.RandomState(SEED)``."""

    ARRAYS = (("images_aif", "img_aif"), ("boundary_locations", "boundary_loc"),
              ("image_depths", "image_depth"), ("boundary_depths", "boundary_depth"),
              ("boundary_distances", "boundary_dist"), ("derivative_maps", "deri"))

    def __init__(self, args, device="cuda", device_batch: int = 50):
        self.device = resolve_device(device)
        self.cfg = ShapeGenConfig(
            H=args.img_size[0], W=args.img_size[1], R=args.R,
            num_shape_lo=args.num_shape[0], num_shape_hi=args.num_shape[1],
            z_lo=args.Z_range[0], z_hi=args.Z_range[1],
            alpha_lo=args.alpha[0], alpha_hi=args.alpha[1],
            sigma_read=args.sigma, mag=args.mag, cam=CamConfig(**args.cam_params))
        self.data_path = args.data_path
        self.num_sample_train = args.num_sample_train
        self.num_sample_val = args.num_sample_val
        self.device_batch = device_batch
        self.scene_gen = torch.Generator().manual_seed(SEED)
        self.noise_gen = torch.Generator(device=self.device).manual_seed(SEED)
        self.rng = np.random.RandomState(SEED)
        self.images = None        # the rounded clean pairs of the last split, uint8

    def _path(self, name, part, sub=""):
        return os.path.join(self.data_path, sub, f"{name}_{part}.npy")

    def _memmap(self, name, part, shape, sub=""):
        os.makedirs(os.path.join(self.data_path, sub), exist_ok=True)
        return np.lib.format.open_memmap(self._path(name, part, sub), mode="w+",
                                         dtype=np.float32, shape=shape)

    def generate_synthetic_data(self, train: bool = True) -> None:
        cfg = self.cfg
        n = self.num_sample_train if train else self.num_sample_val
        part = "train" if train else "val"
        H, W = cfg.H, cfg.W
        shapes = {"images_aif": (n, H, W, 3), "derivative_maps": (n, 2, H, W, 3)}
        out = {name: self._memmap(name, part, shapes.get(name, (n, H, W)))
               for name, _ in self.ARRAYS}
        self.images = np.empty((n, 2, H, W, 3), np.uint8)
        for s in range(0, n, self.device_batch):
            b = min(self.device_batch, n - s)
            draws = {k: v.to(self.device) for k, v in draw_shapes(self.scene_gen, b, cfg).items()}
            batch = synthesize_from_draws(draws, cfg)
            for name, key in self.ARRAYS:
                out[name][s:s + b] = batch[key].cpu().numpy()
            # integers in [0, 255] after the rounding: exact in uint8
            self.images[s:s + b] = batch["imgs"].to(torch.uint8).cpu().numpy()
        for arr in out.values():
            arr.flush()

    def add_noise(self, train: bool = True) -> None:
        cfg = self.cfg
        n = self.images.shape[0]
        part = "train" if train else "val"
        alpha = (torch.rand(n, generator=self.noise_gen, device=self.device)
                 * (cfg.alpha_hi - cfg.alpha_lo) + cfg.alpha_lo)
        self.alpha_list = alpha.cpu().numpy()
        np.save(self._path("alphas", part), self.alpha_list)
        gt = self._memmap("images_gt", part, self.images.shape)
        ny = self._memmap("images_ny", part, self.images.shape)
        for s in range(0, n, self.device_batch):
            e = min(n, s + self.device_batch)
            imgs = torch.from_numpy(self.images[s:e]).to(self.device, torch.float32)
            g, y = add_photon_noise(imgs, alpha[s:e], cfg.sigma_read, self.noise_gen)
            gt[s:e] = g.cpu().numpy()
            ny[s:e] = y.cpu().numpy()
        gt.flush()
        ny.flush()

    def crop_patch(self, train: bool = True) -> None:
        """The boundary-centred R x R patch set (reference
        train_val_data_generator.py:187-275): 2 patches an image, drawn
        without replacement over all candidate pixels of the split, each
        from one aperture drawn at random; the distance transform of each
        patch's own boundary. Reads the split's arrays back from disk."""
        cfg = self.cfg
        R, half = cfg.R, cfg.R // 2
        part = "train" if train else "val"
        n_patch = (self.num_sample_train if train else self.num_sample_val) * 2
        load = lambda name: np.load(self._path(name, part), mmap_mode="r")   # noqa: E731
        bloc = load("boundary_locations")
        n_img = bloc.shape[0]

        cand = np.empty(bloc.shape, bool)
        for s in range(0, n_img, self.device_batch):
            e = min(n_img, s + self.device_batch)
            cand[s:e] = candidate_mask(torch.from_numpy(np.array(bloc[s:e])).to(self.device),
                                       R).cpu().numpy()
        # the draws of np.where(cand) then choice/randint over its length,
        # without the three index arrays of every candidate pixel
        per_img = cand.reshape(n_img, -1).sum(1)
        sel = self.rng.choice(int(per_img.sum()), n_patch, replace=False)
        img_ind = self.rng.randint(0, 2, size=n_patch)
        starts = np.concatenate([[0], np.cumsum(per_img)])
        nn = np.searchsorted(starts, sel, side="right") - 1
        flat_pos = np.empty(n_patch, np.int64)
        for i in np.unique(nn):
            pick = nn == i
            flat_pos[pick] = np.flatnonzero(cand[i])[sel[pick] - starts[i]]
        hh, ww = np.divmod(flat_pos, cfg.W)

        def crop(name, per_aperture):
            arr = load(name)
            out = np.empty((n_patch, R, R) + arr.shape[3 + per_aperture:], np.float32)
            for i in range(n_patch):
                src = arr[nn[i], img_ind[i]] if per_aperture else arr[nn[i]]
                out[i] = src[hh[i] - half:hh[i] - half + R, ww[i] - half:ww[i] - half + R]
            return out

        patches = {"patches_aif": crop("images_aif", False),
                   "patches_gt": crop("images_gt", True),
                   "patches_ny": crop("images_ny", True),
                   "boundary_locations": crop("boundary_locations", False),
                   "image_depths": crop("image_depths", False),
                   "boundary_depths": crop("boundary_depths", False),
                   "derivative_maps": crop("derivative_maps", True)}
        bd = torch.from_numpy(patches["boundary_locations"]).to(self.device)
        patches["boundary_distances"] = distance_transform_l1(bd > 0).cpu().numpy()
        pdir = os.path.join(self.data_path, "patches")
        os.makedirs(pdir, exist_ok=True)
        for name, arr in patches.items():
            np.save(os.path.join(pdir, f"{name}_{part}.npy"), arr)
        np.save(os.path.join(pdir, f"alphas_{part}.npy"), self.alpha_list[nn].astype(np.float32))

    def run(self) -> dict:
        """Both splits through the three phases, as the command line runs
        them; returns the seconds of each phase."""
        seconds = {}
        for train in (True, False):
            part = "train" if train else "val"
            print(f"Generating synthetic data for {'training' if train else 'validation'} set...")
            for phase, fn in (("generate", self.generate_synthetic_data),
                              ("noise", self.add_noise), ("crop", self.crop_patch)):
                t0 = time.perf_counter()
                fn(train=train)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                seconds[f"{part}_{phase}"] = time.perf_counter() - t0
        return seconds
