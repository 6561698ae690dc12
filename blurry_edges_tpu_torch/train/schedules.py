"""Loss-weight and learning-rate schedules as pure functions / tiny state
machines.

Parity targets (a copy of the JAX package's train/schedules.py):
- beta ramp for local training: linear 0 -> max over the first dynamic_epoch
  epochs (reference local_training.py:18-30).
- gamma two-phase piecewise-linear schedule for global training over
  dynamic_epoch = [e0, e1, e2] (reference global_training.py:25-60).
- ReduceLROnPlateau with torch semantics (rel threshold 1e-4, zero cooldown),
  plus the local harness's patience growth 2 + 3*floor(log2(epoch+1))
  (reference local_training.py:88, 111-112) and the global harness's
  "only step after epoch >= e1" gate handled by callers
  (reference global_training.py:220-221).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple


def beta_schedule(epoch: int, dynamic_epoch: int, max_beta_bndry_loc: float,
                  max_beta_smthns: float) -> Tuple[float, float]:
    """(beta_bndry_loc, beta_smthns) at a given epoch index (0-based)."""
    rate = epoch / (dynamic_epoch - 1) if epoch < dynamic_epoch else 1.0
    return rate * max_beta_bndry_loc, rate * max_beta_smthns


def _interp(gamma_range: Sequence[float], rate: float) -> float:
    return gamma_range[0] + rate * (gamma_range[1] - gamma_range[0])


def gamma_schedule(epoch: int, dynamic_epoch: Sequence[int],
                   gamma_ranges: dict) -> dict:
    """Two-phase interpolation: phase 0 ramps range[0]->range[1] over
    [0, e0), holds to e1; phase 1 ramps range[1]->range[2] over [e1, e2),
    holds after (reference global_training.py:28-51).

    gamma_ranges: {name: (g_start, g_mid, g_end)} -> {name: float}.
    """
    e0, e1, e2 = dynamic_epoch
    if epoch < e0:
        rate, lo = epoch / (e0 - 1), 0
    elif epoch < e1:
        rate, lo = 1.0, 0
    elif epoch < e2:
        rate, lo = (epoch - e1) / (e2 - e1 - 1), 1
    else:
        rate, lo = 1.0, 1
    return {k: _interp(v[lo:lo + 2], rate) for k, v in gamma_ranges.items()}


def final_gamma(gamma_ranges: dict) -> dict:
    """Validation always uses the end-of-schedule weights (reference
    global_training.py:53-60)."""
    return {k: v[-1] for k, v in gamma_ranges.items()}


def local_patience(epoch: int) -> int:
    """Patience growth used by the local harness (reference
    local_training.py:111-112)."""
    return 2 + int(math.log2(epoch + 1)) * 3


@dataclasses.dataclass
class PlateauScheduler:
    """torch.optim.lr_scheduler.ReduceLROnPlateau ('min' mode, rel threshold
    1e-4, cooldown 0) as an explicit host-side state machine."""

    lr: float
    factor: float
    patience: int
    min_lr: float
    threshold: float = 1e-4
    best: float = math.inf
    num_bad: int = 0

    def step(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.num_bad > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.num_bad = 0
        return self.lr
