"""Analytic depth-from-defocus: a pair of blur levels (eta1 from aperture
rho_1, eta2 from rho_2) -> metric depth, after projecting the pair onto the
valid DfD curve. Parity: reference utils/depth_etas.py:3-37."""

from __future__ import annotations

import dataclasses
import math

import torch

from ..config import CamConfig, PatchConfig


@dataclasses.dataclass(frozen=True)
class DfDSolver:
    """Closed-form DfD constants (reference utils/depth_etas.py:4-21)."""

    numerator: float
    denominator_constant: float
    denominator_factor_root: float
    intercept: float
    s: float

    theta_mid: float = 3.0 / 4.0 * math.pi
    theta_wng: float = 1.0 / 4.0 * math.pi

    @classmethod
    def from_config(cls, cam: CamConfig, patch: PatchConfig) -> "DfDSolver":
        norm_factor = patch.R // 2
        return cls(
            numerator=2.0 * cam.s**2 * (cam.rho_2 - cam.rho_1),
            denominator_constant=-cam.s * (cam.rho_1 - cam.rho_2)
            * (cam.rho_1 * cam.s + cam.rho_2 * cam.s - 2.0),
            denominator_factor_root=norm_factor * cam.pixel_pitch * patch.mag / cam.sigma_cam,
            intercept=abs(cam.s * (cam.rho_2 - cam.rho_1)) * cam.sigma_cam
            / cam.pixel_pitch / patch.mag / norm_factor,
            s=cam.s)

    @property
    def denominator_factor(self) -> float:
        return self.denominator_factor_root**2

    def etas2depth(self, eta1, eta2):
        """Project (eta1, eta2) onto the valid DfD curve, then invert to
        metric depth. Elementwise."""
        b = self.intercept
        sw, cw = math.sin(self.theta_wng), math.cos(self.theta_wng)
        sm, cm = math.sin(self.theta_mid), math.cos(self.theta_mid)
        cond1 = -sw * eta1 + cw * (eta2 - b)
        cond2 = -sm * (eta1 - b) + cm * eta2
        cond3 = -sw * (eta1 - b) + cw * eta2
        eta11 = torch.where(cond1 > 0, (eta1 + eta2 - b) / 2,
                            torch.where(cond2 > 0, b + (eta1 - eta2 - b) / 2,
                                        torch.where(cond3 < 0, b + (eta1 + eta2 - b) / 2, eta1)))
        eta22 = torch.where(cond1 > 0, b + (eta1 + eta2 - b) / 2,
                            torch.where(cond2 > 0, (eta2 - eta1 + b) / 2,
                                        torch.where(cond3 < 0, (eta1 + eta2 - b) / 2, eta2)))
        return self.numerator / (self.denominator_factor * (eta11**2 - eta22**2)
                                 + self.denominator_constant)

    def depth2sigma(self, depth, rho_prime):
        """Blur level at ``depth`` for an equivalent optical power
        ``rho_prime``, used for the refocused render."""
        return torch.abs((1.0 / depth - rho_prime) * self.s + 1.0) / self.denominator_factor_root
