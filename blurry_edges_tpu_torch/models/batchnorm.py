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
    Normalisation, eval mode and state-dict keys are torch's.

    Under a data mesh of more than one rank (``parallel.active_mesh``) the
    batch is the global one, as under the JAX package's sharded batch: the
    per-channel sums, then the sums of squared deviations, are all-reduced
    by a differentiable all-reduce (``parallel.mesh.all_reduce_sum``), so
    the backward reaches every rank's inputs. (``nn.SyncBatchNorm`` would move
    its running variance toward the unbiased one.)"""

    def __init__(self, num_features: int):
        super().__init__(num_features, momentum=0.01)

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        from ..parallel.mesh import active_mesh

        dims = [0] + list(range(2, x.dim()))
        if active_mesh() is not None:
            return self._global_batch(x, dims)
        with torch.no_grad():
            self.running_mean.lerp_(x.mean(dims), self.momentum)
            self.running_var.lerp_(x.var(dims, unbiased=False), self.momentum)
            self.num_batches_tracked += 1
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)

    def _global_batch(self, x, dims):
        from ..parallel.mesh import all_reduce_sum

        shape = [1, -1] + [1] * (x.dim() - 2)
        n_local = x.numel() // x.shape[1]
        sums = all_reduce_sum(torch.cat([x.sum(dims), x.new_tensor([float(n_local)])]))
        count = sums[-1].detach()
        mean = sums[:-1] / count
        dev = x - mean.view(shape)
        var = all_reduce_sum((dev * dev).sum(dims)) / count
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked += 1
        return dev * torch.rsqrt(var + self.eps).view(shape) * self.weight.view(shape) \
            + self.bias.view(shape)


class BatchNorm1d(_FlaxBatchNorm, nn.BatchNorm1d):
    pass


class BatchNorm2d(_FlaxBatchNorm, nn.BatchNorm2d):
    pass
