"""What every kernel wrapper does around a launch: pick the device, check
its arguments, find the current stream, and raise on a failed launch."""

from __future__ import annotations

import torch


def device_type(*tensors) -> str:
    """'cpu' or 'cuda', the one device type of all ``tensors``."""
    types = {t.device.type for t in tensors}
    if len(types) != 1:
        raise ValueError(f"inputs on several devices: {sorted(types)}")
    kind = types.pop()
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device type {kind!r}")
    return kind


def check(name: str, t: torch.Tensor, shape: tuple, dtype=torch.float32):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def raise_on(rc: int, kernel: str):
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {rc}")
