"""The local stage's trainer (the JAX package's ``train/local.py``; reference
local_training.py:10-122).

AdamW at lr 6e-5 with the global gradient norm clipped at 1.0, batch 64
with the last partial batch dropped, Xavier normal re-initialisation of
every parameter of rank > 1, and the three-term loss: color MSE plus
beta_loc x boundary localisation plus beta_smthns x Sobel smoothness, the
betas ramping linearly over the first ``dynamic_epoch`` epochs. Validation
runs each epoch at the final betas; ReduceLROnPlateau (factor 0.9, min 10%)
with patience 2 + 3 floor(log2(epoch + 1)); the best validation loss's
model is ``best_run_exp_local_stage.pth``. BatchNorm trains in train mode
with Flax's running-statistics update (``models/batchnorm.py``).

The reference's training step solves the wedge colors on the clean patch
(criteria(est, img_gt, img_gt, ...) at local_training.py:105) and its
validation on the noisy one (:61); so do these steps.

The patch set stays resident on the device; a step is one forward and one
backward of the local CNN on a batch, in float32 (TF32 off). Under
``--dp_devices D`` (the JAX package's mesh, ``parallel/mesh.py``) each rank
holds its contiguous share of the patch set and steps on its share of every
global batch.
"""

from __future__ import annotations

import math
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import PatchConfig
from ..models.local_stage import LocalStage
from ..ops.sobel import image_derivative
from ..parallel.mesh import Mesh, make_mesh, mean_gradients
from ..ops.wedge import (boundary_map, dists2indicators, make_patch_grid, params2dists,
                         params2etas, render_patches, solve_colors)
from ..utils.device import float32_precision, resolve_device
from .optim import clip_by_global_norm_, make_optimizer, set_lr, xavier_reinit

TWO_PI = 2.0 * math.pi
SEED = 1869


def local_loss(est, img_for_colors, img_gt, bndry_dist, deri, patch: PatchConfig,
               betas: Tuple[float, float]):
    """The three local loss terms, weighted (reference local_training.py:32-52).

    est (B, 10) raw outputs; images (B, R, R, 3); bndry_dist (B, R, R); deri
    (B, R-2, R-2, 3); betas (beta_bndry_loc, beta_smthns)."""
    R, B = patch.R, est.shape[0]
    x, y = make_patch_grid(R, est.dtype, est.device)
    est = torch.cat([est[:, :4], torch.remainder(est[:, 4:8], TWO_PI), est[:, 8:]], dim=1)
    dists = params2dists(est[:, :8], x, y, patch.w)                   # (B, 2, R, R)
    wedges = dists2indicators(dists, params2etas(est[:, 8:]))         # (B, 3, R, R)
    A = torch.movedim(wedges, -3, -1).reshape(B, R * R, 3)
    colors = solve_colors(A, img_for_colors.reshape(B, R * R, 3), patch.lambda_ridge)
    patches = render_patches(wedges, colors)                          # (B, R, R, 3)
    bmap = boundary_map(dists)

    color_term = ((img_gt - patches) ** 2).sum(-1).mean()
    loc_term = ((bndry_dist * bmap) ** 2).mean()
    smth_term = ((deri - image_derivative(patches)) ** 2).sum(-1).mean()
    return color_term + betas[0] * loc_term + betas[1] * smth_term


def make_step_fns(model: LocalStage, optimizer: torch.optim.Optimizer, patch: PatchConfig,
                  mesh: Optional[Mesh] = None):
    """(train_step, eval_step), each (batch, betas) -> the loss. The train
    step runs the model in train mode (BatchNorm on the batch's statistics,
    moving its running ones), solves the colors on the clean patches, and
    takes one clipped AdamW step; the eval step runs it in eval mode and
    solves them on the noisy ones. Both in float32, TF32 off.

    Under a ``mesh`` of D ranks each rank steps on its share of the global
    batch (BatchNorm on the global batch's statistics): the gradients are
    averaged over the ranks before the clip, which so sees the global
    gradient, and the train step returns the rank's loss (the global
    batch's is the mean over the ranks)."""
    mesh = mesh or make_mesh()
    params = [p for p in model.parameters() if p.requires_grad]

    def train_step(batch, betas):
        model.train()
        with float32_precision():
            est = model(batch["img_ny"])
            loss = local_loss(est, batch["img_gt"], batch["img_gt"], batch["bndry_dist"],
                              batch["deri"], patch, betas)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            mean_gradients(params, mesh)
            clip_by_global_norm_(params, 1.0)
            optimizer.step()
        return loss.detach()

    def eval_step(batch, betas):
        model.eval()
        with float32_precision(), torch.no_grad():
            est = model(batch["img_ny"])
            return local_loss(est, batch["img_ny"], batch["img_gt"], batch["bndry_dist"],
                              batch["deri"], patch, betas)

    return train_step, eval_step


def init_state(seed: int, lr: float, device) -> Tuple[LocalStage, torch.optim.AdamW]:
    """A LocalStage re-initialised as the JAX package's ``init_state`` does
    (Xavier normal from ``seed``), on ``device``, and its optimizer."""
    model = LocalStage()
    xavier_reinit(model, torch.Generator().manual_seed(seed))
    model.to(device)
    return model, make_optimizer(model.parameters(), lr)




def run_local_training(args, snapshot_every: int = 25, resume: bool = True,
                       device="cuda", mesh: Optional[Mesh] = None) -> dict:
    """The local trainer's harness (reference local_training.py:68-122): the
    normalised patch sets resident on ``device``; per epoch a shuffled pass
    (the shuffle derived from the epoch, so a resumed run takes the same
    batches) and a validation sweep; ``best_run_exp_local_stage.pth`` (the
    model's state dict, as ``load_inference_modules`` and the precal read
    it) on each new best; a snapshot of the whole training state,
    ``last_exp_local_stage.pth``, every ``snapshot_every`` epochs, from
    which a later call resumes; the log, the loss curve (saved each epoch)
    and its plot. Returns the curve, the best epoch and loss, the epoch it
    started from and the steps it took.

    ``mesh`` (``parallel.make_mesh`` inside a rank; the JAX package's
    ``mesh``): each rank keeps its contiguous share of both patch sets
    resident; every rank derives the same shuffle, the global batch's rows
    are put together from the shares that hold them (``gather_rows``) and
    each rank takes its share of the batch, which must divide by the
    ranks; the validation sums are all-reduced; rank 0 writes the
    checkpoints, the log and the curve, and the ranks meet at a barrier
    after each epoch's files."""
    from ..config import patch_from_args
    from ..data.datasets import BatchIterator, ShapeDataset
    from ..parallel.mesh import (all_reduce, barrier, data_sharding, gather_rows, replicate,
                                 shard_batch)
    from ..utils.io import TrainLogger, create_directory, show_curve
    from ..utils.seeding import set_seed
    from . import schedules
    from .checkpoint import save_checkpoint
    from .resume import load_step_snapshot, save_step_snapshot

    device = resolve_device(device)
    mesh = mesh or make_mesh(getattr(args, "dp_devices", 0), device=device)
    root_seed = set_seed(SEED)
    if mesh.is_main:
        create_directory(args.log_path, overwrite=False)
    barrier(mesh)
    patch = patch_from_args(args)
    bs = args.batch_size
    if bs % mesh.size:
        raise ValueError(f"batch size {bs} does not split over {mesh.size} ranks")
    share = data_sharding(bs, mesh)
    t_start = time.time()

    def say(msg):
        if mesh.is_main:
            print(f"[local +{time.time() - t_start:7.1f}s] {msg}", flush=True)

    def resident(train):
        ds = ShapeDataset(args.data_path, train=train, mode="local")
        part = shard_batch(ds.batch(np.arange(len(ds))), mesh)
        return ({k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                 for k, v in part.items()}, data_sharding(len(ds), mesh).start, len(ds))

    (data_train, start_train, n_train), (data_val, start_val, n_val) = \
        resident(True), resident(False)
    say(f"data resident on {device}: {n_train} train and {n_val} val patches"
        + (f", a share on each of {mesh.size} ranks" if mesh.size > 1 else ""))

    model, optimizer = init_state(root_seed, args.learning_rate, device)
    replicate(model, mesh)
    train_step, eval_step = make_step_fns(model, optimizer, patch, mesh)
    sched = schedules.PlateauScheduler(lr=args.learning_rate, factor=0.9, patience=2,
                                       min_lr=args.learning_rate * 0.1)
    final_betas = (args.beta_bndry_loc, args.beta_smthns)
    nb_train, nb_val = n_train // bs, n_val // bs
    best_loss, best_epoch, start_epoch = np.inf, 0, 0
    snap_path = f"{args.model_path}/last_exp_local_stage"
    curve_path = f"{args.log_path}/loss_curve_exp_local_stage.npy"
    curve = np.zeros((args.epoch_num,), dtype=float)
    resumed = False
    if resume:
        snap = load_step_snapshot(snap_path, model, optimizer)
        if snap is not None:
            sched, mid = snap
            start_epoch, best_loss, best_epoch = mid["epoch"], mid["best_loss"], mid["best_epoch"]
            resumed = True
            prev = np.load(curve_path)
            curve[:min(len(prev), len(curve))] = prev[:len(curve)]
            say(f"RESUMED at epoch {start_epoch} (best {best_loss:.6f} @ {best_epoch})")
    logger = (TrainLogger(f"{args.log_path}/exp_local_stage_training.txt", args, append=resumed)
              if mesh.is_main else None)

    def batch_share(data, start, idx):
        rows = gather_rows(data, start, idx, mesh)
        return {k: v[share] for k, v in rows.items()}

    steps = 0
    for epoch in range(start_epoch, args.epoch_num):
        betas = schedules.beta_schedule(epoch, args.dynamic_epoch, *final_betas)
        loss_sum = torch.zeros((), device=device)
        for idx in BatchIterator(n_train, bs, shuffle=True, seed=root_seed + 7919 * epoch):
            loss_sum += train_step(batch_share(data_train, start_train, idx), betas)
            steps += 1
        val_sum = torch.zeros((), device=device)
        for b in range(nb_val):
            val_sum += eval_step(batch_share(data_val, start_val, np.arange(b * bs, (b + 1) * bs)),
                                 final_betas)
        sums = all_reduce(torch.stack([loss_sum, val_sum]), mesh) / mesh.size
        curve[epoch] = float(sums[1]) / max(nb_val, 1)

        lr = sched.step(curve[epoch])
        sched.patience = schedules.local_patience(epoch)
        set_lr(optimizer, lr)
        say(f"epoch {epoch} train {float(sums[0]) / max(nb_train, 1):.6f} "
            f"val {curve[epoch]:.6f} lr {lr:.4e}")
        if curve[epoch] < best_loss:
            best_loss, best_epoch = curve[epoch], epoch
            if mesh.is_main:
                save_checkpoint(f"{args.model_path}/best_run_exp_local_stage", model.state_dict())
        if mesh.is_main:
            logger.epoch(epoch, curve[epoch], sched.patience, lr)
            np.save(curve_path, curve)
            if snapshot_every and (epoch + 1) % snapshot_every == 0:
                save_step_snapshot(snap_path, model, optimizer, sched, epoch=epoch + 1, step=0,
                                   loss_sum=0.0, loss_count=0, best_loss=best_loss,
                                   best_epoch=best_epoch)
        barrier(mesh)

    if mesh.is_main:
        show_curve(args.log_path, curve, "loss_curve_exp_local_stage")
        logger.footer(best_epoch, best_loss)
        logger.close()
    barrier(mesh)
    return dict(curve=curve, best_epoch=best_epoch, best_loss=best_loss,
                start_epoch=start_epoch, steps=steps)
