"""Patch extraction (unfold) and overlap-add (fold) with torch.nn.Fold
semantics, NHWC at the interface.

Canonical patch layout: (N, Hp, Wp, R, R, C) with
Hp = floor((H - R) / stride) + 1.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def unfold(img, R: int, stride: int):
    """img (N, H, W, C) -> (N, Hp, Wp, R, R, C), all R x R patches at
    ``stride``."""
    # (N, H, W, C) -> (N, Hp, W, C, R) -> (N, Hp, Wp, C, R, R): a strided view
    patches = img.unfold(1, R, stride).unfold(2, R, stride)
    return patches.permute(0, 1, 2, 4, 5, 3).contiguous()


def fold(patches, H: int, W: int, stride: int):
    """Overlap-add (the adjoint of unfold): (N, Hp, Wp, R, R, C) ->
    (N, H, W, C). Divide by fold_count for the overlap mean."""
    N, Hp, Wp, R, R2, C = patches.shape
    cols = patches.permute(0, 5, 3, 4, 1, 2).reshape(N, C * R * R2, Hp * Wp)
    out = F.fold(cols, output_size=(H, W), kernel_size=(R, R2), stride=stride)
    return out.permute(0, 2, 3, 1)


def fold_count(H: int, W: int, R: int, stride: int, dtype=torch.float32,
               device=None):
    """Overlap count per output pixel, (H, W)."""
    Hp = (H - R) // stride + 1
    Wp = (W - R) // stride + 1
    ones = torch.ones((1, Hp, Wp, R, R, 1), dtype=dtype, device=device)
    return fold(ones, H, W, stride)[0, :, :, 0]


def unfold_flat_cm(img, R: int, stride: int):
    """Channel-major flat unfold: img (N, H, W, C) -> (N, C, Hp*Wp, R*R),
    pixel (di, dj) of patch (i, j) at index di*R + dj, the values of
    ``unfold``."""
    N, H, W, C = img.shape
    cols = F.unfold(img.permute(0, 3, 1, 2), kernel_size=R, stride=stride)
    return cols.reshape(N, C, R * R, -1).transpose(-1, -2)


def fold_flat(patches, H: int, W: int, R: int, stride: int):
    """Overlap-add of flat patches, the adjoint of ``unfold_flat_cm`` per
    leading row: (M, Hp*Wp, R*R) -> (M, H, W)."""
    M, L, RR = patches.shape
    Hp = (H - R) // stride + 1
    Wp = (W - R) // stride + 1
    if L != Hp * Wp or RR != R * R:
        raise ValueError(f"patches {tuple(patches.shape)} do not tile {H}x{W} "
                         f"with R={R}, stride={stride}")
    out = F.fold(patches.transpose(-1, -2), output_size=(H, W),
                 kernel_size=R, stride=stride)
    return out[:, 0]
