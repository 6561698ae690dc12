"""Model checkpoints as ``.pth`` files (``torch.save`` of a state dict under
the port's keys, which are the reference's), written atomically."""

from __future__ import annotations

import os
from typing import Any

import torch


def pth_path(path: str) -> str:
    """``path`` with the ``.pth`` suffix."""
    return path if path.endswith(".pth") else path + ".pth"


def save_checkpoint(path: str, obj: Any) -> str:
    """``torch.save`` ``obj`` to ``<path>.pth`` through a temporary file, so a
    reader never sees half a checkpoint; returns the file's path."""
    path = pth_path(os.path.abspath(path))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, map_location="cpu") -> Any:
    return torch.load(pth_path(os.path.abspath(path)), map_location=map_location,
                      weights_only=True)


def checkpoint_exists(path: str) -> bool:
    return os.path.isfile(pth_path(os.path.abspath(path)))
