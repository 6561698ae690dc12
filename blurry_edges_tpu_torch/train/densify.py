"""The depth-completion (densify ``pp``) U-Net's trainer, the JAX package's
``train/densify.py`` (the reference ships no trainer for it).

Two sources of (sparse depth -> dense depth) training pairs over the
basic-shape train/val set:

1. ``pipeline``: the trained local and global stages run over the set's
   noisy pairs through the serving estimator (``make_batched_depth_
   estimator``: the wedge_colors and wedge_render kernels on the card),
   and the confidence-thresholded folded depth is the input, the
   generator's dense ``image_depths`` the target;
2. ``simulated``: the pipeline's sparsity drawn from the ground truth
   (``make_sparse_from_gt``: depth kept on a band of random width about
   the boundaries, pixel dropout, multiplicative noise).

``realistic_dirs`` adds the pairs of realistic-generator sets to the
pipeline-sourced ones (their planar depth ramps close the gap to the eval
protocol's scenes).

Training: AdamW (lr 1e-4) after a global-norm clip of 1.0, MSE (plus
``grad_loss_w`` x first-difference gradient matching) with BatchNorm in
train mode, plain MSE for validation, a plateau schedule (factor 0.9,
patience 5, floor 10%), the best validation epoch's U-Net saved as
``best_run_exp_depth_completion_pp.pth``. Random draws come from seeded
CPU generators, so a run draws the same numbers on any device; they are
not ``jax.random``'s numbers, so the functions take the draws as arguments
where the tests feed the JAX package's own.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from ..models.unet import UNet
from ..ops.morphology import distance_transform_l1
from ..utils.device import float32_precision, resolve_device
from ..utils.seeding import fold_in
from .optim import clip_by_global_norm_, flax_default_init, make_optimizer, set_lr

SEED = 1869
Z_RANGE = (0.75, 1.18)
# pairs a call of the batched estimator takes when it makes the sparse maps:
# the fastest of 4, 8 and 16 in chip_smoke.py's sweep on an H100 80GB HBM3
# at 700 W (8.86, 8.59 and 8.51 maps/s)
SPARSE_CHUNK = 4


def sparse_draws(g: torch.Generator, B: int, H: int, W: int) -> Dict[str, torch.Tensor]:
    """The random draws of ``make_sparse_from_gt`` for B maps, on the CPU:
    band widths (B,) in 3..10, a uniform keep field and a normal noise
    field (B, H, W)."""
    return dict(width=torch.randint(3, 11, (B,), generator=g).float(),
                keep=torch.rand((B, H, W), generator=g),
                noise=torch.randn((B, H, W), generator=g))


def make_sparse_from_gt(image_depth, boundary_loc, width, keep, noise, z_range=Z_RANGE):
    """The pipeline's sparse pattern simulated from ground truth: depth kept
    where the city-block distance to the boundary is at most ``width`` and
    ``keep`` > 0.15, times (1 + 0.02 ``noise``), clipped to [0, z_range[1]].

    image_depth / boundary_loc / keep / noise (..., H, W), width (...,).
    Returns (sparse, kept mask)."""
    dist = distance_transform_l1(boundary_loc > 0)
    band = dist <= width[..., None, None]
    mask = band & (keep > 0.15)
    sparse = torch.where(mask, image_depth * (1.0 + 0.02 * noise), 0.0)
    return sparse.clamp(0.0, z_range[1]), mask


def masked_mse(pred, target):
    """MSE over all pixels (the dense target is defined everywhere)."""
    return ((pred - target) ** 2).mean()


def grad_matching(pred, target):
    """First-difference gradient matching: the mean squared difference of
    the vertical and of the horizontal first differences, summed."""
    dpy = pred[:, 1:, :] - pred[:, :-1, :]
    dty = target[:, 1:, :] - target[:, :-1, :]
    dpx = pred[:, :, 1:] - pred[:, :, :-1]
    dtx = target[:, :, 1:] - target[:, :, :-1]
    return ((dpy - dty) ** 2).mean() + ((dpx - dtx) ** 2).mean()


def flip_draws(g: torch.Generator, B: int) -> torch.Tensor:
    """(B, 2) booleans: flip sample b vertically, horizontally."""
    return torch.rand((B, 2), generator=g) < 0.5


def rand_flips(flips, sparse, target):
    """Per-sample flips of (B, H, W) maps: rows where ``flips[:, 0]``, then
    columns where ``flips[:, 1]`` (the task is equivariant to them)."""
    f0 = flips[:, 0].to(sparse.device)[:, None, None]
    f1 = flips[:, 1].to(sparse.device)[:, None, None]
    sparse, target = (torch.where(f0, x.flip(-2), x) for x in (sparse, target))
    return tuple(torch.where(f1, x.flip(-1), x) for x in (sparse, target))


def make_steps(model: UNet, optimizer: torch.optim.Optimizer, grad_loss_w: float = 0.0,
               augment: bool = False):
    """(train_step, eval_step) of the JAX package's ``make_steps``.

    ``train_step(sparse (B, 1, H, W), target (B, H, W), flips=None)`` runs
    the U-Net in train mode (BatchNorm on the batch's statistics, Flax's
    running update), takes MSE plus ``grad_loss_w`` x grad matching, clips
    the gradients to a global norm of 1.0 and takes one AdamW step; with
    ``augment`` it first flips each sample by ``flips`` (B, 2). It returns
    the loss. ``eval_step(sparse, target)`` is the eval-mode MSE. Both in
    float32, TF32 off."""
    params = [p for p in model.parameters() if p.requires_grad]

    def train_step(sparse, target, flips=None):
        if augment:
            if flips is None:
                raise ValueError("augment=True needs each step's flips")
            sp, target = rand_flips(flips, sparse[:, 0], target)
            sparse = sp[:, None]
        model.train()
        with float32_precision():
            pred = model(sparse)[:, 0]
            loss = masked_mse(pred, target)
            if grad_loss_w:
                loss = loss + grad_loss_w * grad_matching(pred, target)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            clip_by_global_norm_(params, 1.0)
            optimizer.step()
        return loss.detach()

    def eval_step(sparse, target):
        # validation stays plain MSE whatever the train terms
        model.eval()
        with float32_precision(), torch.no_grad():
            return masked_mse(model(sparse)[:, 0], target)

    return train_step, eval_step


def init_state(lr: float, device):
    """A U-Net with Flax's default initialisation, seeded (the JAX
    ``init_state``: ``model.init``), on ``device``, and its optimizer."""
    model = UNet()
    flax_default_init(model, torch.Generator().manual_seed(SEED))
    model.to(device)
    return model, make_optimizer(model.parameters(), lr)


def run_densify_training(args, epochs: int = 100, batch_size: int = 8,
                         lr: float = 1e-4, source: str = "simulated",
                         modules=None, max_samples=None,
                         realistic_dirs=None, grad_loss_w: float = 0.0,
                         augment: bool = False, device="cuda") -> dict:
    """Train the densifier on the basic-shape train/val set at
    ``args.data_path`` (the JAX ``run_densify_training``).

    ``max_samples``: an optional (n_train, n_val) cap. ``realistic_dirs``:
    an optional (train_dir, val_dir) of realistic-generator sets whose
    pairs are added; it needs ``source="pipeline"`` and ``modules``. The
    arrays stay on the host as numpy; a batch at a time goes to
    ``device``. Batches drop the last partial one; the train shuffle is
    seeded 1869 + epoch; ``simulated`` validation draws are a function of
    the batch's first index, the same every epoch. Writes the checkpoint
    under ``args.model_path``, the log, the curve and its plot under
    ``args.log_path``. Returns the curve, the best epoch and loss, the
    steps, and the seconds of sparse-map generation, of training and of
    each epoch."""
    from ..utils.io import TrainLogger, create_directory, show_curve
    from ..utils.seeding import set_seed
    from .checkpoint import save_checkpoint
    from .schedules import PlateauScheduler

    device = resolve_device(device)
    set_seed(SEED)
    create_directory(args.log_path, overwrite=False)

    caps = dict(zip(("train", "val"), max_samples)) if max_samples else {}
    depths = {p: np.load(f"{args.data_path}/image_depths_{p}.npy")
              .astype(np.float32)[:caps.get(p)] for p in ("train", "val")}
    bnds = {p: np.load(f"{args.data_path}/boundary_locations_{p}.npy")
            .astype(np.float32)[:caps.get(p)] for p in ("train", "val")}
    H, W = depths["train"].shape[1:]

    t0 = time.time()
    sparse_maps = None
    if source == "pipeline":
        sparse_maps = {p: _pipeline_sparse_depths(args, p, modules, caps.get(p), device=device)
                       for p in ("train", "val")}
    elif source != "simulated":
        raise ValueError(f"source must be 'simulated' or 'pipeline', got {source!r}")
    if realistic_dirs is not None:
        if source != "pipeline" or modules is None:
            raise ValueError("realistic_dirs needs the trained pipeline (source='pipeline')")
        for p, d in zip(("train", "val"), realistic_dirs):
            r_sparse, r_depth = _realistic_sparse_pairs(args, d, modules, device=device)
            print(f"densify: +{len(r_depth)} realistic {p} pairs from {d}", flush=True)
            sparse_maps[p] = np.concatenate([sparse_maps[p], r_sparse])
            depths[p] = np.concatenate([depths[p], r_depth])
    sparse_seconds = time.time() - t0

    model, optimizer = init_state(lr, device)
    train_step, eval_step = make_steps(model, optimizer, grad_loss_w=grad_loss_w,
                                       augment=augment)
    sched = PlateauScheduler(lr=lr, factor=0.9, patience=5, min_lr=lr * 0.1)

    def batches(part, shuffle, seed):
        n = depths[part].shape[0]
        order = np.random.default_rng(seed).permutation(n) if shuffle else np.arange(n)
        for s in range(0, n - batch_size + 1, batch_size):
            yield order[s:s + batch_size]

    def sparse_batch(part, idx, g):
        tgt = torch.from_numpy(depths[part][idx]).to(device)
        if sparse_maps is not None:
            sp = torch.from_numpy(sparse_maps[part][idx]).to(device)
        else:
            draws = {k: v.to(device) for k, v in sparse_draws(g, len(idx), H, W).items()}
            sp, _ = make_sparse_from_gt(tgt, torch.from_numpy(bnds[part][idx]).to(device),
                                        **draws)
        return sp[:, None], tgt

    best, best_epoch, steps = np.inf, 0, 0
    curve = np.zeros(epochs)
    epoch_seconds = []
    logger = TrainLogger(f"{args.log_path}/exp_depth_completion_training.txt", args)
    t_train = time.time()
    for epoch in range(epochs):
        t_epoch = time.time()
        g = torch.Generator().manual_seed(fold_in(SEED, epoch))
        for idx in batches("train", True, SEED + epoch):
            sp, tgt = sparse_batch("train", idx, g)
            train_step(sp, tgt, flip_draws(g, len(idx)) if augment else None)
            steps += 1

        val = torch.zeros((), device=device)
        nv = 0
        for idx in batches("val", False, 0):
            g_val = torch.Generator().manual_seed(fold_in(SEED + 1, int(idx[0])))
            val += eval_step(*sparse_batch("val", idx, g_val))
            nv += 1
        curve[epoch] = float(val) / max(nv, 1)
        lr_now = sched.step(curve[epoch])
        set_lr(optimizer, lr_now)
        logger.epoch(epoch, curve[epoch], sched.patience, lr_now)
        if curve[epoch] < best:
            best, best_epoch = curve[epoch], epoch
            save_checkpoint(f"{args.model_path}/best_run_exp_depth_completion_pp",
                            model.state_dict())
        epoch_seconds.append(time.time() - t_epoch)
        print(f"[densify] epoch {epoch} val {curve[epoch]:.6f} lr {lr_now:.4e} "
              f"({epoch_seconds[-1]:.1f}s)", flush=True)

    np.save(f"{args.log_path}/loss_curve_exp_depth_completion.npy", curve)
    show_curve(args.log_path, curve, "loss_curve_exp_depth_completion")
    logger.footer(best_epoch, best)
    logger.close()
    return dict(curve=curve, best_epoch=best_epoch, best_loss=best, steps=steps,
                sparse_seconds=sparse_seconds, train_seconds=time.time() - t_train,
                epoch_seconds=epoch_seconds,
                n_train=len(depths["train"]), n_val=len(depths["val"]))


def _pipeline_sparse_depths(args, part: str, modules, n: Optional[int] = None,
                            chunk: int = SPARSE_CHUNK, device="cuda") -> np.ndarray:
    """The trained pipeline's confidence-thresholded folded depths over the
    first ``n`` noisy pairs of the shape set's ``part``."""
    from ..data import datasets

    if modules is None:
        raise ValueError("source='pipeline' needs the trained InferenceModules")
    ds = datasets.ShapeDataset(args.data_path, train=part == "train", mode="global_pre")
    total = len(ds) if n is None else min(n, len(ds))
    return _sparse_from_batches(args, lambda idx: ds.batch(idx)["img_ny"], total, modules,
                                chunk, device)


def _realistic_sparse_pairs(args, data_dir: str, modules, chunk: int = SPARSE_CHUNK,
                            device="cuda"):
    """(sparse inputs, dense targets) of a realistic-generator set: the
    pipeline's depths over its noisy pairs divided by alpha, and its
    ``depth_maps``."""
    from ..data import datasets

    ds = datasets.TestDataset(data_dir)
    a = ds.alpha.reshape((-1,) + (1,) * (ds.img_ny.ndim - 1))
    imgs = (ds.img_ny / a).astype(np.float32)
    sparse = _sparse_from_batches(args, lambda idx: imgs[idx], len(ds), modules, chunk, device)
    return sparse, ds.depth_map.astype(np.float32)


def _sparse_from_batches(args, get_batch, total: int, modules, chunk: int = SPARSE_CHUNK,
                         device="cuda") -> np.ndarray:
    """``depth_final`` of the batched estimator (densify None) over pairs
    0..total-1, ``chunk`` pairs a call, the last call padded with its last
    pair to the chunk; (total, H, W) float32 on the host."""
    from ..config import cam_from_args, grid_from_args, patch_from_args
    from ..eval import pipeline

    grid = grid_from_args(args)
    if total == 0:
        return np.zeros((0, grid.H, grid.W), np.float32)
    estimate = pipeline.make_batched_depth_estimator(
        modules, patch_from_args(args), grid, cam_from_args(args), densify=None,
        device=device)
    out = []
    for s in range(0, total, chunk):
        idx = np.arange(s, min(s + chunk, total))
        imgs = get_batch(idx)
        pad = chunk - len(idx)
        if pad:
            imgs = np.concatenate([imgs, np.repeat(imgs[-1:], pad, 0)])
        # depth_final is (B, 1, H, W): each pair's maps keep a leading axis
        out.append(estimate(imgs)["depth_final"][:len(idx), 0].cpu().numpy())
    return np.concatenate(out)
