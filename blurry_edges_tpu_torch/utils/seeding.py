"""Seeds and the keyed random draws of training.

``set_seed`` seeds Python's, numpy's and torch's global generators and
returns the root seed. ``fold_in`` derives a new seed from a seed and an
integer (the epoch, the step, a chunk, a layer), as ``jax.random.fold_in``
derives keys: every random draw of a training step is a function of
(seed, epoch, step, ...) alone, so a recomputed forward (activation
checkpointing) draws the same dropout masks, and a resumed run the same
masks as an uninterrupted one. The numbers differ from JAX's from the same
seed.
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch

_MASK64 = (1 << 64) - 1


def set_seed(seed: int) -> int:
    """Seed the global generators; returns ``seed``, the root of fold_in."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    return seed


def fold_in(seed: int, data: int) -> int:
    """A seed derived from ``seed`` and ``data`` (splitmix64 of their mix),
    in [0, 2^63)."""
    z = (seed * 0x9E3779B97F4A7C15 + data + 0x632BE59BD9B4E019) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def generator(seed: int, device) -> torch.Generator:
    """A torch.Generator on ``device`` seeded with ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g
