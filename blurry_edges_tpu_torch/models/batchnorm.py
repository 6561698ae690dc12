"""BatchNorm layers with Flax's training update, for the port's CNNs (the
LocalStage and the depth-completion U-Net)."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class _FlaxBatchNorm:
    """Flax ``nn.BatchNorm``'s training update: running statistics move by
    momentum 0.99 (torch's ``momentum=0.01``) toward the batch mean and the
    biased batch variance (torch's own update takes the unbiased one).
    Normalisation, eval mode and state-dict keys are torch's."""

    def __init__(self, num_features: int):
        super().__init__(num_features, momentum=0.01)

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        dims = [0] + list(range(2, x.dim()))
        with torch.no_grad():
            self.running_mean.lerp_(x.mean(dims), self.momentum)
            self.running_var.lerp_(x.var(dims, unbiased=False), self.momentum)
            self.num_batches_tracked += 1
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


class BatchNorm1d(_FlaxBatchNorm, nn.BatchNorm1d):
    pass


class BatchNorm2d(_FlaxBatchNorm, nn.BatchNorm2d):
    pass
