#!/usr/bin/env python3
"""Write what the PyTorch port's evaluation reads on a machine without JAX:
the committed weights as ``.pth`` state dicts, and test sets with uint8
photon counts.

    python export_torch_assets.py weights [--model_path ./pretrained_weights] [--out runs/torch_assets/weights]
    python export_torch_assets.py testset --src runs/gen/data_test --out runs/torch_assets/data_test [--start 0 --stop 30]

``weights`` reads each committed Orbax checkpoint through the JAX package
and maps it onto the port's state dict by the bridge
(``blurry_edges_tpu_torch/models/weights.py``: ``jax_local_to_torch``,
``jax_global_to_torch``, ``jax_unet_to_torch``), saved as
``<name>.pth`` under the checkpoint's own name, which the port's
``load_inference_modules`` resolves.

``testset`` copies a test set written by ``test_data_generator.py``
(``images_ny.npy``, ``depth_maps.npy``, ``alphas.npy``; pairs ``start`` to
``stop``) with ``images_ny`` as uint8: the generator rounds and clips its
photon counts to [0, alpha] with alpha at most 200, so uint8 holds them
exactly. It refuses counts that are not integers in [0, 255]. The depth
maps and alphas stay float32. The port's ``TestDataset`` loads either
form as float32.

The tool imports JAX; nothing of the port imports it. Write under ``runs/``
(git-ignored).
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

CHECKPOINTS = {   # committed checkpoint -> the bridge that maps it
    "best_run_exp_local_stage": "local",
    "best_run_exp_global_stage": "global",
    "best_run_exp_global_stage_w": "global",
    "best_run_exp_global_stage_big": "global",
    "best_run_exp_depth_completion_pp": "unet",
}


def to_numpy(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def bridge_checkpoint(ckpt: dict, kind: str) -> dict:
    """A checkpoint's Flax variables (params, batch_stats) -> the port's
    state dict."""
    from blurry_edges_tpu_torch.models import weights as w

    params = to_numpy(ckpt["params"])
    if kind == "local":
        return w.jax_local_to_torch(params, to_numpy(ckpt["batch_stats"]))
    if kind == "unet":
        return w.jax_unet_to_torch(params, to_numpy(ckpt["batch_stats"]))
    return w.jax_global_to_torch(params)


def export_weights(model_path: str, out: str, names=tuple(CHECKPOINTS)) -> list:
    """Each named checkpoint under ``model_path`` -> ``<out>/<name>.pth``.
    Returns the paths written."""
    import torch

    from blurry_edges_tpu.train.checkpoint import load_checkpoint

    os.makedirs(out, exist_ok=True)
    written = []
    for name in names:
        sd = bridge_checkpoint(load_checkpoint(os.path.join(model_path, name)), CHECKPOINTS[name])
        path = os.path.join(out, f"{name}.pth")
        torch.save(sd, path)
        written.append(path)
        print(f"{name}: {sum(v.numel() for v in sd.values())} values -> {path}", flush=True)
    return written


def counts_to_uint8(images_ny: np.ndarray) -> np.ndarray:
    """Photon counts -> uint8, refusing any value that is not an integer in
    [0, 255] (the cast would change it)."""
    bad = (images_ny != np.round(images_ny)) | (images_ny < 0) | (images_ny > 255)
    if bad.any():
        raise ValueError(f"{int(bad.sum())} photon counts are not integers in [0, 255] "
                         f"(e.g. {images_ny[bad].ravel()[:3]}); uint8 would change them")
    return images_ny.astype(np.uint8)


def export_test_set(src: str, out: str, start: int = 0, stop: int = None) -> int:
    """Pairs ``start:stop`` of the test set in ``src`` -> ``out``, images as
    uint8. Returns the number of pairs written."""
    sl = slice(start, stop)
    images = np.load(os.path.join(src, "images_ny.npy"), mmap_mode="r")[sl]
    depth = np.load(os.path.join(src, "depth_maps.npy"), mmap_mode="r")[sl]
    alphas = np.load(os.path.join(src, "alphas.npy"))[sl]
    os.makedirs(out, exist_ok=True)
    np.save(os.path.join(out, "images_ny.npy"), counts_to_uint8(np.asarray(images)))
    np.save(os.path.join(out, "depth_maps.npy"), np.asarray(depth, np.float32))
    np.save(os.path.join(out, "alphas.npy"), np.asarray(alphas, np.float32))
    print(f"{src}[{start}:{stop}] -> {out}: {len(alphas)} pairs, images {images.shape} uint8",
          flush=True)
    return len(alphas)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = parser.add_subparsers(dest="what", required=True)
    pw = sub.add_parser("weights", help="committed checkpoints -> .pth")
    pw.add_argument("--model_path", default="./pretrained_weights")
    pw.add_argument("--out", default="runs/torch_assets/weights")
    pt = sub.add_parser("testset", help="a generated test set -> uint8 images")
    pt.add_argument("--src", required=True)
    pt.add_argument("--out", required=True)
    pt.add_argument("--start", type=int, default=0)
    pt.add_argument("--stop", type=int, default=None)
    args = parser.parse_args(argv)
    if args.what == "weights":
        export_weights(args.model_path, args.out)
    else:
        export_test_set(args.src, args.out, args.start, args.stop)


if __name__ == "__main__":
    main()
