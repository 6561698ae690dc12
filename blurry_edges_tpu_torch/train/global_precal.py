"""Global pre-calculation: the frozen local stage's tokens of every image
pair of a dataset, the global stage's training input (reference
global_data_pre_cal.py:10-70).

``make_precal_fn`` runs the estimators' first stage
(``eval/pipeline.py::local_tokens``) over a device batch of noisy pairs in
float32 (TF32 off), and ``run_global_precal`` writes
``params_src_{train,val}.npy`` (N, 2, Hp*Wp, 19) through ``open_memmap``, 8
pairs a device batch.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..config import GridConfig, PatchConfig
from ..eval.pipeline import local_tokens
from ..models.local_stage import LocalStage
from ..models.weights import LOCAL_NAMES, resolve_weights
from ..utils.device import float32_precision


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
