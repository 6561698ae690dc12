"""Parameter packing transforms between the local stage (10 raw parameters
per patch), the global stage's 38-feature tokens and its 12 outputs.

Parity: reference global_data_pre_cal.py:20-30 and
blurry_edges_test.py:124-138.
"""

from __future__ import annotations

import math

import torch

from .wedge import params2etas

PI = math.pi
TWO_PI = 2.0 * math.pi


def wrap_local_params(params):
    """Wrap the four angle channels of (..., 10) raw outputs into [0, 2pi)."""
    return torch.cat([params[..., :4],
                      torch.remainder(params[..., 4:8], TWO_PI),
                      params[..., 8:]], dim=-1)


def normalize_token_features(params, colors):
    """(wrapped params (..., 10), colors (..., 3 wedges, C)) -> 19 normalized
    features: xy/3, (angles-pi)/pi, eta_coefs - 0.5, (colors-0.5)*2.

    The 9 color features are channel-major (channel*3 + wedge), as the
    reference flattens them (global_data_pre_cal.py:47-50).
    """
    colors_flat = colors.transpose(-1, -2).reshape(colors.shape[:-2] + (9,))
    return torch.cat([
        params[..., :4] / 3.0,
        (params[..., 4:8] - PI) / PI,
        params[..., 8:10] - 0.5,
        (colors_flat - 0.5) * 2.0,
    ], dim=-1)


def denormalize_global_train(est):
    """Training-path denormalization of (..., 12) global outputs (reference
    global_training.py:141-145) -> (xy_angles (..., 8), etas (..., 4)), the
    etas already mapped through params2etas(coef + 0.5)."""
    xy = est[..., :4] * 3.0
    angles = torch.remainder((est[..., 4:8] + 1.0) * PI, TWO_PI)
    etas = params2etas(est[..., 8:] + 0.5)
    return torch.cat([xy, angles], dim=-1), etas


def denormalize_global_eval(est):
    """Inference-path denormalization of (..., 12) global outputs: xy*3,
    angles wrapped to [0, 2pi), eta coefficients + 0.5 (the caller applies
    params2etas)."""
    xy = est[..., :4] * 3.0
    angles = torch.remainder((est[..., 4:8] + 1.0) * PI, TWO_PI)
    eta_coefs = est[..., 8:] + 0.5
    return torch.cat([xy, angles, eta_coefs], dim=-1)
