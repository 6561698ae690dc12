"""Sobel gradient magnitude (reference utils/postprocessing_loss.py:19-20,
114-117): valid-mode correlation with the Sobel pair, per channel, then
sqrt(gx^2 + gy^2 + eps).

``image_derivative`` works on images (..., H, W, C); ``image_derivative_flat``
on flattened R x R patches, as a product with a dense (R-2)^2 x R^2 matrix.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

_SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))
_SOBEL_Y = ((1.0, 2.0, 1.0), (0.0, 0.0, 0.0), (-1.0, -2.0, -1.0))


def image_derivative(img, eps: float = 1e-8):
    """Sobel gradient magnitude, valid padding, channelwise:
    img (..., H, W, C) -> (..., H-2, W-2, C)."""
    lead = img.shape[:-3]
    H, W, C = img.shape[-3:]
    x = img.reshape((-1, H, W, C)).permute(0, 3, 1, 2)
    k = torch.tensor((_SOBEL_X, _SOBEL_Y), dtype=img.dtype, device=img.device)
    k = k[:, None].repeat(C, 1, 1, 1)                    # (2C, 1, 3, 3): x, y per channel
    g = F.conv2d(x, k, groups=C)                         # (n, 2C, H-2, W-2)
    gx, gy = g[:, 0::2], g[:, 1::2]
    out = torch.sqrt(gx**2 + gy**2 + eps).permute(0, 2, 3, 1)
    return out.reshape(lead + (H - 2, W - 2, C))


@functools.lru_cache(maxsize=8)
def _sobel_flat_matrices(R: int):
    """Dense (R-2)^2 x R^2 matrices applying the valid-mode Sobel pair to a
    flattened R x R patch."""
    sx, sy = np.array(_SOBEL_X), np.array(_SOBEL_Y)
    O = R - 2
    Mx = np.zeros((O * O, R * R), np.float32)
    My = np.zeros_like(Mx)
    for i in range(O):
        for j in range(O):
            for di in range(3):
                for dj in range(3):
                    src = (i + di) * R + (j + dj)
                    Mx[i * O + j, src] = sx[di, dj]
                    My[i * O + j, src] = sy[di, dj]
    return Mx, My


def image_derivative_flat(p, R: int, eps: float = 1e-8):
    """Sobel gradient magnitude on flattened patches: p (..., R*R) ->
    (..., (R-2)^2), the values of ``image_derivative`` on the (R, R)
    patches. Both products sum in float32 when TF32 is off."""
    Mx, My = (torch.from_numpy(m).to(p.device, p.dtype) for m in _sobel_flat_matrices(R))
    gx = torch.matmul(p, Mx.T)
    gy = torch.matmul(p, My.T)
    return torch.sqrt(gx**2 + gy**2 + eps)
