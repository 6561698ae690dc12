"""Device selection and numeric precision for the port's entry points."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device) -> torch.device:
    """Entry points default to ``"cuda"``; without a GPU that raises, so a
    caller that wants the CPU has to say ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU")
    return dev


@contextlib.contextmanager
def float32_precision():
    """Matmuls and cuDNN convolutions in full float32 inside the block: TF32
    off (PyTorch leaves it on for cuDNN by default), as the float32 reference
    computes. The caller's settings are restored on exit."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved
