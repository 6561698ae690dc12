"""Camera, patch and patch-grid geometry (frozen dataclasses).

Same fields and defaults as the JAX package's configuration (reference
utils/args.py:11-15, 42 and utils/postprocessing_loss.py:135-137).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class CamConfig:
    """Two-aperture thin-lens camera parameters."""

    s: float = 0.1104
    rho_1: float = 10.0
    rho_2: float = 10.2
    sigma_cam: float = 0.003
    pixel_pitch: float = 5.86e-6

    @property
    def rhos(self) -> Tuple[float, float]:
        return (self.rho_1, self.rho_2)


@dataclasses.dataclass(frozen=True)
class PatchConfig:
    """Patch geometry shared by every stage."""

    R: int = 21  # patch size
    w: float = 1.0  # wedge back-side SDF weight
    alpha_lambda: float = 5e-3  # ridge lambda = (alpha_lambda * R^2)^2
    stride: int = 2
    mag: float = 4.0

    @property
    def lambda_ridge(self) -> float:
        return (self.alpha_lambda * self.R**2) ** 2


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """Patch-grid geometry for a given image size."""

    H: int = 147
    W: int = 147
    R: int = 21
    stride: int = 2

    @property
    def H_patches(self) -> int:
        return int(math.floor((self.H - self.R) / self.stride) + 1)

    @property
    def W_patches(self) -> int:
        return int(math.floor((self.W - self.R) / self.stride) + 1)

    @property
    def num_tokens(self) -> int:
        return self.H_patches * self.W_patches
