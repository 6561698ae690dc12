"""147x147 inference: image pair -> dense depth, confidence, the restored,
sharpened and refocused images and the boundary map.

The chain (reference blurry_edges_test.py:117-145): unfold the pair into
2 x L patches; local CNN; wedge colors per patch (wedge_colors kernel);
19-feature tokens; global transformer; denormalize and params2etas; the full
render (wedge_render kernel); overlap-add fold; the densify: a threshold on
the confidence (0.05, or 0.0 with hard wedge masks for ``densify="w"``), or
for ``densify="pp"`` the depth-completion U-Net over the folded global
depth. On CUDA tensors both wedge steps are the hand-written kernels; on
CPU tensors their plain versions. An estimator runs its models in full
float32, with TF32 off for the call whatever the caller's setting, as the
float32 reference does; models built with ``dtype=torch.bfloat16`` (the
``--serve_dtype bfloat16`` of ``run_eval``) compute in bfloat16, and their
outputs are cast back to float32 where the JAX package casts them: the
local CNN's in ``local_tokens``, the global stage's and the U-Net's here.
Everything after those casts (the wedge kernels, DfD, fold and the 0.05
threshold) is float32.

``run_eval`` is the dataset loop of the JAX package's ``run_eval``
(reference blurry_edges_test.py:102-172), on one device or, under
``--dp_devices D``, in groups of D pairs over D ranks (``parallel/mesh.py``).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..config import CamConfig, GridConfig, PatchConfig
from ..models.global_stage import GlobalStage
from ..models.local_stage import LocalStage
from ..models.unet import UNet
from ..ops.dfd import DfDSolver
from ..ops.params import denormalize_global_eval
from ..ops.patchify import fold, fold_count, unfold
from ..ops.wedge import params2etas
from ..ops.wedge_cuda import wedge_render
from ..utils.device import float32_precision, resolve_device

DENSIFY_MODES = (None, "w", "pp")


@dataclasses.dataclass
class InferenceModules:
    """The models of the pipeline, with their weights; the U-Net only for
    ``densify="pp"``."""

    local_model: LocalStage
    global_model: GlobalStage
    unet_model: Optional[UNet] = None


# The JAX package's render_full (eval/pipeline.py:45-73): pair renders with a
# joint color solve, sharpened and refocused renders, boundary map, DfD depth
# and wedge mask, same arguments and layouts. On CUDA tensors it is the
# wedge_render kernel, on CPU tensors its plain version.
render_full = wedge_render


def fold_outputs(rend, grid: GridConfig):
    """Overlap-add every rendered patch grid into image maps (reference
    blurry_edges_test.py:95-100)."""
    H, W, R, stride = grid.H, grid.W, grid.R, grid.stride
    dm = rend["depth_mask"]
    dtype, device = rend["depth_map"].dtype, dm.device
    count = fold_count(H, W, R, stride, dtype, device)

    def fold_sum(p):  # (..., Hp, Wp, R, R, C) -> (..., H, W, C)
        lead = p.shape[:-5]
        out = fold(p.reshape((-1,) + p.shape[-5:]), H, W, stride)
        return out.reshape(lead + out.shape[1:])

    def fmean(p):
        return fold_sum(p) / count[:, :, None]

    global_image = fmean(rend["patches"])                         # (B,2,H,W,3)
    global_shpd = fmean(rend["patches_shpd"])                     # (B,H,W,3)
    global_refoc = fmean(rend["patches_refoc"])
    global_bndry = fmean(rend["local_bndry"][..., None])[..., 0]  # (B,H,W)

    num_depth = fold_sum((dm > 0).to(dtype)[..., None])[..., 0]   # (B,H,W)
    confidence = num_depth / count
    depth_sum = fold_sum(rend["depth_map"][..., None])[..., 0]
    global_depth = depth_sum / torch.where(num_depth > 0, num_depth, 1.0)

    return dict(global_image=global_image, global_shpd=global_shpd,
                global_refoc=global_refoc, global_bndry=global_bndry,
                global_depth=global_depth, confidence=confidence)


def _as_tensor(imgs) -> torch.Tensor:
    """A numpy array or tensor of images -> a float32 tensor."""
    if torch.is_tensor(imgs):
        return imgs
    return torch.from_numpy(np.ascontiguousarray(imgs, dtype=np.float32))


def make_render_fn(mods: InferenceModules, patch_cfg: PatchConfig,
                   grid: GridConfig, cam: CamConfig, hard_mask: bool,
                   rho_prime: float) -> Callable:
    """(B, 2, H, W, 3) float32 image pairs on the models' device -> the
    render of every patch (``render_full``'s dict, leading B axis): local
    tokens, the global stage (its output cast to float32), denormalize and
    params2etas, the render. The per-pair (and, on the 587x587 path, the
    per-block) core; the caller sets eval mode, inference mode and the
    precision."""
    from ..train.global_precal import local_tokens

    dfd = DfDSolver.from_config(cam, patch_cfg)
    Hp, Wp, L, R = grid.H_patches, grid.W_patches, grid.num_tokens, grid.R

    def render(imgs):
        B = imgs.shape[0]
        tokens, _ = local_tokens(mods.local_model, imgs, patch_cfg, grid)  # (B,2,L,19)
        src = tokens.permute(0, 2, 1, 3).reshape(B, L, 38)
        est = mods.global_model(src).float()
        den = denormalize_global_eval(est).reshape(B, Hp, Wp, 12)
        xy_angles = den[..., :8].contiguous()
        etas = params2etas(den[..., 8:]).contiguous()

        img_patches = unfold(imgs.reshape((B * 2,) + imgs.shape[2:]), R, grid.stride)
        img_patches = img_patches.reshape((B, 2) + img_patches.shape[1:])
        return render_full(xy_angles, etas, img_patches, patch_cfg, dfd,
                           rho_prime, hard_mask)

    return render


def _make_estimate_fn(mods: InferenceModules, patch_cfg: PatchConfig,
                      grid: GridConfig, cam: CamConfig,
                      densify: Optional[str], rho_prime: float,
                      device) -> Callable:
    """(B, 2, H, W, 3) image pairs -> maps with a leading B axis."""
    if densify not in DENSIFY_MODES:
        raise ValueError(f"densify must be one of {DENSIFY_MODES}, got {densify!r}")
    if densify == "pp" and mods.unet_model is None:
        raise ValueError("densify='pp' needs InferenceModules.unet_model, the "
                         "depth-completion U-Net")
    device = resolve_device(device)
    mods.local_model.eval()   # inference: BatchNorm on its running statistics
    mods.global_model.eval()
    if densify == "pp":
        mods.unet_model.eval()
    hard = densify == "w"
    depth_thres = 0.0 if hard else 0.05
    render = make_render_fn(mods, patch_cfg, grid, cam, hard, rho_prime)

    @torch.inference_mode()
    @float32_precision()
    def estimate(imgs):
        imgs = imgs.to(device=device, dtype=torch.float32)
        out = fold_outputs(render(imgs), grid)
        if densify == "pp":
            # the raw folded depth, not the thresholded one; in eval mode one
            # pass over the batch is B single-pair passes
            out["depth_final"] = mods.unet_model(out["global_depth"][:, None])[:, 0].float()
        else:
            out["depth_final"] = torch.where(out["confidence"] > depth_thres,
                                             out["global_depth"], 0.0)
        return out

    return estimate


def make_depth_estimator(mods: InferenceModules, patch_cfg: PatchConfig,
                         grid: GridConfig, cam: CamConfig,
                         densify: Optional[str] = None,
                         rho_prime: float = 10.39,
                         device="cuda") -> Callable:
    """Single pair: (2, H, W, 3) -> maps with a leading axis of 1
    (global_image (1,2,H,W,3), global_shpd (1,H,W,3), confidence (1,H,W),
    ...), as the JAX ``make_depth_estimator`` returns them. ``mods`` must
    live on ``device``."""
    fn = _make_estimate_fn(mods, patch_cfg, grid, cam, densify, rho_prime, device)

    def estimate(img_pair):
        return fn(_as_tensor(img_pair)[None])

    return estimate


def make_batched_depth_estimator(mods: InferenceModules, patch_cfg: PatchConfig,
                                 grid: GridConfig, cam: CamConfig,
                                 densify: Optional[str] = None,
                                 rho_prime: float = 10.39,
                                 device="cuda") -> Callable:
    """Throughput variant: (B, 2, H, W, 3) -> the single-pair maps stacked on
    a leading B axis (global_image (B,1,2,H,W,3), confidence (B,1,H,W), ...),
    as the JAX vmapped estimator returns them; one pass over the batch."""
    fn = _make_estimate_fn(mods, patch_cfg, grid, cam, densify, rho_prime, device)

    def estimate(img_pairs):
        return {k: v[:, None] for k, v in fn(_as_tensor(img_pairs)).items()}

    return estimate


def synchronize(device) -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed_groups(ds, n: int, estimate, mesh, group: Optional[int] = None):
    """(j, img_ny, gt_depth, out, seconds) for pairs 0..n-1: the loop of the
    JAX package's ``run_eval``, for any D. Pairs go in groups of ``group``
    (default D): pair g + r on rank r, the last group padded with its last
    pair (the pads not yielded), every rank's maps gathered to every rank.
    ``group`` 1 gives every rank the same pair (``run_eval_big`` splits
    each pair's blocks over the ranks). A group is timed from the rank's
    numpy array to a finished device (the JAX loop times ``jnp.asarray`` to
    ``block_until_ready``); seconds a pair = the group's time / its size."""
    from ..parallel.mesh import all_gather, barrier

    size = group or mesh.size
    for g in range(0, n, size):
        idx = list(range(g, min(g + size, n)))
        mine = idx[min(mesh.rank, len(idx) - 1)]
        img_mine = ds[mine]
        barrier(mesh)
        t0 = time.time()
        out = estimate(img_mine[0])
        outs = ({k: all_gather(v, mesh) for k, v in out.items()} if size > 1  # (D, 1, ...)
                else {k: v[None] for k, v in out.items()})
        synchronize(mesh.device)
        dt = (time.time() - t0) / size
        for i, j in enumerate(idx):
            img_ny, gt_depth = img_mine if j == mine else ds[j]
            yield j, img_ny, gt_depth, {k: v[i] for k, v in outs.items()}, dt


def score_pairs(args, pairs, n: int, visualizer=None) -> dict:
    """The evaluation loop of the JAX package's ``run_eval`` and
    ``run_eval_big`` over ``pairs`` (``timed_groups``):
    per-image metrics and prints, images with no predicted pixel inside the
    crop excluded from the averages (their masked metrics are 0/0), and the
    dataset averages. The estimator has been called once already."""
    from .metrics import eval_depth

    totals = np.zeros(5)
    total_time = 0.0
    n_scored = 0
    for j, img_ny, gt_depth, out, dt in pairs:
        total_time += dt
        depth = out["depth_final"].cpu().numpy()
        msk = depth > 0.0
        inner = msk[:, args.crop:-args.crop, args.crop:-args.crop] \
            if args.crop > 0 else msk
        if not inner.any():
            # zero predicted pixels: the masked metrics are 0/0 (undefined);
            # exclude the image from the average instead of poisoning it
            # with nan, and say so
            print(f"Image pair #{j}: no predicted pixels above threshold; "
                  f"excluded from averages, time ={dt: .3f} s", flush=True)
            continue
        m = eval_depth(depth, gt_depth[None], msk, crop=args.crop)
        totals += np.asarray(m)
        n_scored += 1
        print(f"Image pair #{j}: delta1 ={m[0]: .3f}, delta2 ={m[1]: .3f}, "
              f"delta3 ={m[2]: .3f}, RMSE ={m[3]: .3f} cm, AbsRel ={m[4]: .3f} cm, "
              f"time ={dt: .3f} s", flush=True)
        if visualizer is not None:
            visualizer(j, img_ny, gt_depth, {k: v.cpu().numpy() for k, v in out.items()})

    if n_scored < n:
        print(f"\n{n - n_scored}/{n} images had empty predictions and were "
              f"excluded from the metric averages", flush=True)
    avg = totals / max(n_scored, 1)
    # the subset basis travels with the summary line itself
    basis = f" (over {n_scored}/{n} scored images)" if n_scored < n else ""
    print(f"\nAverage running time:{total_time / n: .3f} s")
    print(f"Average metrics for whole dataset: delta1 ={avg[0]: .3f}, "
          f"delta2 ={avg[1]: .3f}, delta3 ={avg[2]: .3f}, RMSE ={avg[3]: .3f} cm, "
          f"AbsRel ={avg[4]: .3f} cm{basis}", flush=True)
    return dict(delta1=avg[0], delta2=avg[1], delta3=avg[2], rmse=avg[3],
                absrel=avg[4], avg_time=total_time / n,
                pairs_per_sec=n / total_time)


def scored(args, pairs, n: int, mesh, visualizer) -> Optional[dict]:
    """``score_pairs`` on rank 0; the other ranks run the loop's
    collectives and return None."""
    if mesh.is_main:
        return score_pairs(args, pairs, n, visualizer)
    for _ in pairs:
        pass
    return None


def run_eval(args, modules: InferenceModules, visualizer=None, max_images=None,
             profile_dir: Optional[str] = None, device="cuda", mesh=None) -> Optional[dict]:
    """147x147 dataset evaluation (the JAX package's ``run_eval``): ``args``
    from ``config.get_args("eval")``, the models on ``device``. The warm-up
    call on pair 0 is outside the timed loop. ``profile_dir`` writes a
    ``torch.profiler`` trace of the timed loop there (``trace.json``).
    Returns delta1..3, rmse, absrel (averages over the scored images),
    avg_time and pairs_per_sec.

    ``mesh`` (``parallel.make_mesh`` inside a rank, ``--dp_devices``): the
    pairs go in groups of D, one a rank (``timed_groups``); rank 0 scores,
    prints and visualizes them in order and returns the dict, the other
    ranks return None."""
    from ..config import cam_from_args, grid_from_args, patch_from_args
    from ..data.datasets import TestDataset
    from ..parallel.mesh import make_mesh

    device = resolve_device(device)
    mesh = mesh or make_mesh(getattr(args, "dp_devices", 0), device=device)
    estimate = make_depth_estimator(modules, patch_from_args(args), grid_from_args(args),
                                    cam_from_args(args), densify=args.densify,
                                    rho_prime=args.rho_prime, device=device)
    ds = TestDataset(args.data_path)
    n = len(ds) if max_images is None else min(max_images, len(ds))

    estimate(ds[0][0])            # warm-up, outside the timed region
    synchronize(device)
    pairs = timed_groups(ds, n, estimate, mesh)
    if not profile_dir:
        return scored(args, pairs, n, mesh, visualizer)
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=activities) as prof:
        res = scored(args, pairs, n, mesh, visualizer)
    if mesh.is_main:
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    return res
