"""npy-backed datasets and a batch-index iterator (the JAX package's
``data/datasets.py``; reference data/dataset.py:6-73): the same artifact
names, the noisy and clean images divided by each sample's photon level
alpha, the derivative maps' 1:-1 crops. ``images_ny.npy`` of a test set may
hold float32 or uint8 photon counts: both load as float32."""

from __future__ import annotations

import os
from typing import Dict, Iterator

import numpy as np


class ShapeDataset:
    """mode='local'      -> patches_ny/a, patches_gt/a, boundary_dist, deri[1:-1]
    mode='global_pre' -> images_ny/a
    mode='global'     -> params_src, images_ny/a, images_gt/a, boundary_dist,
                         deri[:, 1:-1, 1:-1], boundary_depth
    (reference data/dataset.py:10-56). ``global_pre`` keeps images_ny
    memory-mapped: ``batch`` reads only the pairs it is given."""

    def __init__(self, data_path: str = ".", train: bool = False, mode: str = "local"):
        part = "train" if train else "val"
        self.mode = mode
        ld = lambda name: np.load(f"{data_path}/{name}_{part}.npy").astype(np.float32)  # noqa: E731
        if mode == "local":
            self.img_ny = ld("patches_ny")
            self.img_gt = ld("patches_gt")
            self.alpha = ld("alphas")
            self.bndry_dist = ld("boundary_distances")
            self.deri = ld("derivative_maps")[:, 1:-1, 1:-1, :]
        elif mode == "global_pre":
            self.img_ny = np.load(f"{data_path}/images_ny_{part}.npy", mmap_mode="r")
            self.alpha = ld("alphas")
        elif mode == "global":
            self.input_param = ld("params_src")
            self.img_ny = ld("images_ny")
            self.img_gt = ld("images_gt")
            self.deri = ld("derivative_maps")[:, :, 1:-1, 1:-1, :]
            self.bndry_dist = ld("boundary_distances")
            self.bndry_depth = ld("boundary_depths")
            self.alpha = ld("alphas")
        else:
            raise ValueError(f"unknown mode {mode!r}")

    def __len__(self) -> int:
        return self.img_ny.shape[0]

    def batch(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        """A normalised batch gathered by indices."""
        a = self.alpha[idx]
        a_im = a.reshape((-1,) + (1,) * (self.img_ny.ndim - 1))
        out = {"img_ny": np.asarray(self.img_ny[idx], np.float32) / a_im}
        if self.mode == "local":
            out.update(img_gt=self.img_gt[idx] / a_im, bndry_dist=self.bndry_dist[idx],
                       deri=self.deri[idx])
        elif self.mode == "global":
            out.update(input_param=self.input_param[idx], img_gt=self.img_gt[idx] / a_im,
                       bndry_dist=self.bndry_dist[idx], deri=self.deri[idx],
                       bndry_depth=self.bndry_depth[idx])
        return out


class TestDataset:
    """(images_ny / alpha, depth_maps) pairs (reference data/dataset.py:58-73)."""

    def __init__(self, data_path: str = "."):
        self.img_ny = np.load(os.path.join(data_path, "images_ny.npy")).astype(np.float32)
        self.depth_map = np.load(os.path.join(data_path, "depth_maps.npy")).astype(np.float32)
        self.alpha = np.load(os.path.join(data_path, "alphas.npy")).astype(np.float32)

    def __len__(self) -> int:
        return self.img_ny.shape[0]

    def __getitem__(self, idx: int):
        return self.img_ny[idx] / self.alpha[idx], self.depth_map[idx]


class BatchIterator:
    """Shuffled (or sequential) fixed-size batches of indices, the last
    partial batch dropped (reference DataLoader usage at
    local_training.py:77-80). The trainers make one an epoch, seeded by the
    epoch, so a resumed run takes the same batches."""

    def __init__(self, n: int, batch_size: int, shuffle: bool, seed: int = 0):
        self.n = n
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self.n // self.batch_size

    def __iter__(self) -> Iterator[np.ndarray]:
        order = self.rng.permutation(self.n) if self.shuffle else np.arange(self.n)
        for s in range(0, len(self) * self.batch_size, self.batch_size):
            yield order[s:s + self.batch_size]
