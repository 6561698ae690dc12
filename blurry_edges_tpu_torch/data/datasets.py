"""Test-set loader (reference data/dataset.py:58-73), the same code as the
JAX package's ``data/datasets.py::TestDataset``. ``images_ny.npy`` may hold
float32 or uint8 photon counts: both load as float32."""

from __future__ import annotations

import os

import numpy as np


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
