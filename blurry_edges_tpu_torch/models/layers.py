"""Convolution and linear layers with a compute dtype, as Flax's ``Conv``,
``Dense`` and ``ConvTranspose`` with ``dtype=`` and float32 parameters (the
JAX package's ``--serve_dtype bfloat16``).

In float32 each layer is its ``torch.nn`` parent, unchanged. In bfloat16
it casts its input, its kernel and its bias to bfloat16 (the parameters
stay float32, and so does the state dict), runs the convolution or product
with a bfloat16 result, then adds the bias in bfloat16: Flax adds the bias
to the rounded product (``y = dot(x, k); y += b``), so the bias is not
folded into the product's float32 accumulator.

The norms compute in float32 and return bfloat16, as Flax's ``BatchNorm``
and ``LayerNorm`` with ``dtype=bfloat16`` do (``x - mean`` promotes to
float32, the result is cast to the layer's dtype): ``F.batch_norm`` does so
itself given a bfloat16 input and float32 statistics and parameters;
``LayerNorm`` below normalises a float32 copy (CUDA's ``layer_norm`` takes
no bfloat16 input with float32 parameters). Activations, pooling, padding
and concatenation follow their input's dtype in both frameworks.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def _add_bias(y, bias, dtype, channel_dim: int):
    if bias is None:
        return y
    shape = [1] * y.dim()
    shape[channel_dim] = -1
    return y + bias.to(dtype).view(shape)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype``."""

    compute_dtype = torch.float32

    def forward(self, x):
        dt = self.compute_dtype
        if dt == torch.float32:
            return super().forward(x)
        y = self._conv_forward(x.to(dt), self.weight.to(dt), None)
        return _add_bias(y, self.bias, dt, 1)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` computing in ``compute_dtype`` (no output size
    argument: the U-Net's stride-2, 2x2 upsampling)."""

    compute_dtype = torch.float32

    def forward(self, x):
        dt = self.compute_dtype
        if dt == torch.float32:
            return super().forward(x)
        y = F.conv_transpose2d(x.to(dt), self.weight.to(dt), None, self.stride,
                               self.padding, self.output_padding, self.groups,
                               self.dilation)
        return _add_bias(y, self.bias, dt, 1)


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype``."""

    compute_dtype = torch.float32

    def forward(self, x):
        dt = self.compute_dtype
        if dt == torch.float32:
            return super().forward(x)
        return _add_bias(F.linear(x.to(dt), self.weight.to(dt)), self.bias, dt, -1)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm``; a bfloat16 input is normalised in float32 and the
    result rounded to bfloat16."""

    def forward(self, x):
        if x.dtype != torch.bfloat16:
            return super().forward(x)
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(x.dtype)


def set_compute_dtype(model: nn.Module, dtype) -> nn.Module:
    """Set the compute dtype of every layer of ``model`` that has one (the
    layers above, the global stage and its attention); returns ``model``.
    The parameters are not touched."""
    if dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute dtype must be one of {COMPUTE_DTYPES}, got {dtype}")
    for mod in model.modules():
        if hasattr(type(mod), "compute_dtype"):
            mod.compute_dtype = dtype
    return model
