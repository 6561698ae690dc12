"""Global pre-calculation: the frozen local stage's tokens of every image
pair of a dataset, the global stage's training input (reference
global_data_pre_cal.py:10-70).

``local_tokens`` unfolds each image pair into patches, runs the local CNN,
wraps the angles, solves each patch's wedge colors on its noisy pixels
(the ``wedge_colors`` kernel on CUDA tensors, its plain version on CPU
tensors) and normalises to 19 features; the estimators share it.
``make_precal_fn`` runs it over a device batch of pairs in float32 (TF32
off), and ``run_global_precal`` writes ``params_src_{train,val}.npy`` (N, 2,
Hp*Wp, 19) through ``open_memmap``, 8 pairs a device batch.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..config import GridConfig, PatchConfig
from ..models.local_stage import LocalStage
from ..ops.params import normalize_token_features, wrap_local_params
from ..ops.patchify import unfold
from ..ops.wedge_cuda import wedge_colors
from ..utils.device import float32_precision


def solve_patch_colors(params, patch_pixels, patch_cfg: PatchConfig):
    """Per-patch ridge colors: params (..., 10), patch_pixels (..., R, R, 3)
    -> (..., 3, 3). CUDA tensors go through the wedge_colors kernel, CPU
    tensors through its plain version."""
    lead = params.shape[:-1]
    R = patch_cfg.R
    colors = wedge_colors(params.reshape(-1, 10).contiguous(),
                          patch_pixels.reshape(-1, R, R, 3).contiguous(),
                          patch_cfg)
    return colors.reshape(lead + (3, 3))


def local_tokens(model: LocalStage, img_pairs, patch_cfg: PatchConfig,
                 grid: GridConfig):
    """Image pairs (B, 2, H, W, 3), alpha-normalized -> normalized tokens
    (B, 2, L, 19) and wrapped raw params (B, 2, L, 10), L = Hp * Wp."""
    B = img_pairs.shape[0]
    L, R = grid.num_tokens, grid.R
    patches = unfold(img_pairs.reshape((B * 2,) + img_pairs.shape[2:]),
                     R, grid.stride)                         # (2B, Hp, Wp, R, R, 3)
    flat = patches.reshape(B * 2 * L, R, R, 3)
    # a bfloat16 CNN's output is cast back here: the colors and tokens are
    # float32 (the JAX package's global_precal.py:108)
    params = wrap_local_params(model(flat).float())          # (2BL, 10)
    colors = solve_patch_colors(params, flat, patch_cfg)     # (2BL, 3, 3)
    tokens = normalize_token_features(params, colors)
    return tokens.reshape(B, 2, L, 19), params.reshape(B, 2, L, 10)


def make_precal_fn(model: LocalStage, patch_cfg: PatchConfig, grid: GridConfig):
    """(B, 2, H, W, 3) alpha-normalised pairs on the model's device -> their
    tokens (B, 2, Hp*Wp, 19), the model in eval mode, in float32 (TF32
    off), without autograd."""
    model.eval()

    @torch.inference_mode()
    @float32_precision()
    def fn(img_pairs):
        return local_tokens(model, img_pairs, patch_cfg, grid)[0]

    return fn


def load_local_stage(model_path: str, device) -> LocalStage:
    """The LocalStage of ``<model_path>/<name>.pth``, by the JAX package's
    names and order (``pretrained_local_stage``, then
    ``best_run_exp_local_stage``), on ``device``; prints the file."""
    from ..utils.weights import LOCAL_NAMES, resolve_weights

    path = resolve_weights(model_path, LOCAL_NAMES)
    if path is None:
        raise FileNotFoundError(f"no weights for any of {LOCAL_NAMES} under {model_path}")
    model = LocalStage()
    model.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    print(f"weights: local stage <- {path}", flush=True)
    return model.to(device).eval()


def run_global_precal(args, device_batch: int = 8, device="cuda") -> dict:
    """The pre-calculation harness (reference global_data_pre_cal.py:52-70):
    for the train and val splits under ``args.data_path``, the tokens of
    every pair, ``device_batch`` pairs a batch, written to
    ``params_src_{train,val}.npy``. Returns the seconds of each split."""
    from ..config import grid_from_args, patch_from_args
    from ..data.datasets import ShapeDataset
    from ..utils.device import resolve_device

    device = resolve_device(device)
    patch_cfg, grid = patch_from_args(args), grid_from_args(args)
    fn = make_precal_fn(load_local_stage(args.model_path, device), patch_cfg, grid)
    seconds = {}
    for train, part in ((True, "train"), (False, "val")):
        t0 = time.perf_counter()
        ds = ShapeDataset(args.data_path, train=train, mode="global_pre")
        n = len(ds)
        out = np.lib.format.open_memmap(
            os.path.join(args.data_path, f"params_src_{part}.npy"), mode="w+",
            dtype=np.float32, shape=(n, 2, grid.num_tokens, 19))
        for s in range(0, n, device_batch):
            e = min(n, s + device_batch)
            batch = torch.from_numpy(ds.batch(np.arange(s, e))["img_ny"]).to(device)
            out[s:e] = fn(batch).cpu().numpy()
        out.flush()
        del out
        seconds[part] = time.perf_counter() - t0
        print(f"precal {part}: {n} pairs in {seconds[part]:.1f} s", flush=True)
    return seconds
