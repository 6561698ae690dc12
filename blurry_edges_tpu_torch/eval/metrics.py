"""Depth metrics (reference utils/metrics.py:3-21): predictions clipped to
[z_min, z_max], an optional center crop, the delta_n accuracies on
[0, 1]-normalized depths, RMSE and AbsRel times 100 (centimeters). numpy,
on the host, once a pair; the same code as the JAX package's
``eval/metrics.py``."""

from __future__ import annotations

import numpy as np


def eval_depth(pred, gt, msk, crop: int = 0, tau_n: float = 1.25,
               z_min: float = 0.75, z_max: float = 1.18):
    """pred/gt/msk: (N, H, W). Returns (delta1, delta2, delta3, RMSE_cm,
    AbsRel_cm)."""
    pred = pred.clip(z_min, z_max)
    if crop > 0:
        pred = pred[:, crop:-crop, crop:-crop]
        gt = gt[:, crop:-crop, crop:-crop]
        msk = msk[:, crop:-crop, crop:-crop]
    error = np.abs(gt - pred)
    pred_n = ((pred - z_min) / (z_max - z_min)).clip(0, 1)
    gt_n = ((gt - z_min) / (z_max - z_min)).clip(0, 1)
    n = np.sum(msk)
    acc = np.maximum(gt_n / (pred_n + 1e-8), pred_n / (gt_n + 1e-8))
    delta1 = np.sum((acc < tau_n) * msk) / n
    delta2 = np.sum((acc < tau_n**2) * msk) / n
    delta3 = np.sum((acc < tau_n**3) * msk) / n
    rmse = np.sqrt(np.sum(error**2 * msk) / n)
    absrel = np.sum(error * msk / gt * msk) / n
    return delta1, delta2, delta3, rmse * 100, absrel * 100
