"""``cv2.resize(a, (w, h))`` with its default ``INTER_LINEAR`` on ``uint8``
images, in integer tensor arithmetic on any device, bit for bit as
OpenCV 5.0.0 computes it on x86 (its 8-bit path is fixed point):

- each output coordinate's source position is ``(d + 0.5) * (src / dst) -
  0.5`` (float32), split into ``floor`` and a fraction; both taps' weights
  are ``1 - f`` and ``f`` rounded to 11 bits (x 2048, half to even);
- along x the position is clamped at the borders (weight 1 on the first or
  last column); along y it is not: the two rows are clamped, each keeping
  its weight;
- the horizontal pass sums ``src * weight`` exactly in int32;
- the vertical pass is OpenCV's SIMD one (``VResizeLinearVec_32s8u``, which
  covers whole rows here): each row's sum shifted right by 4, multiplied by
  its weight keeping the high 16 bits, the two added, then rounded by
  ``(s + 2) >> 2`` and saturated to [0, 255]. The scalar formula, ``(S0 b0
  + S1 b1 + 2^21) >> 22``, differs from it by one level at a few percent of
  the pixels.

The JAX package's test-set loader resizes its MS-COCO masks, objects and
Painting backgrounds with ``cv2.resize`` (``data/realistic_gen.py``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

COEF_BITS = 11
COEF_SCALE = 1 << COEF_BITS


@functools.lru_cache(maxsize=64)
def linear_taps(src: int, dst: int, clamp: bool):
    """(i0, i1, w0, w1) int64 arrays of OpenCV's linear taps along one axis:
    source indices (clamped into the image) and their 11-bit weights."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    i0 = np.floor(f).astype(np.int64)
    f = f - i0.astype(np.float32)
    if clamp:
        low, high = i0 < 0, i0 >= src - 1
        f[low | high] = 0
        i0[low], i0[high] = 0, src - 1
    w1 = np.rint(f * np.float32(COEF_SCALE)).astype(np.int64)
    w0 = np.rint((np.float32(1) - f) * np.float32(COEF_SCALE)).astype(np.int64)
    return np.clip(i0, 0, src - 1), np.clip(i0 + 1, 0, src - 1), w0, w1


def resize_linear_u8(img: torch.Tensor, w: int, h: int) -> torch.Tensor:
    """(H, W) or (H, W, C) uint8 -> (h, w) or (h, w, C) uint8 on ``img``'s
    device, as ``cv2.resize(img, (w, h))``."""
    if img.dtype != torch.uint8 or img.dim() not in (2, 3):
        raise TypeError(f"resize_linear_u8 takes a 2-D or 3-D uint8 tensor, got "
                        f"{tuple(img.shape)} {img.dtype}")
    dev = img.device
    src = img if img.dim() == 3 else img[..., None]
    H, W = src.shape[:2]
    taps = lambda n, m, clamp: [torch.from_numpy(t).to(dev)          # noqa: E731
                                for t in linear_taps(n, m, clamp)]
    x0, x1, a0, a1 = taps(W, w, True)
    y0, y1, b0, b1 = taps(H, h, False)
    s = src.to(torch.int32)
    row = s[:, x0] * a0[None, :, None].int() + s[:, x1] * a1[None, :, None].int()  # (H, w, C)
    b0, b1 = b0[:, None, None].int(), b1[:, None, None].int()
    out = (((row[y0] >> 4) * b0) >> 16) + (((row[y1] >> 4) * b1) >> 16)
    out = ((out + 2) >> 2).clamp(0, 255).to(torch.uint8)
    return out if img.dim() == 3 else out[..., 0]
