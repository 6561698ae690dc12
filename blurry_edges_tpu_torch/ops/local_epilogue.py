"""The LocalStage CNN's tail after a layer, at each of its ten junctions:
the convolution's bias, eval BatchNorm, optionally a skip (a residual
convolution's bias and BatchNorm, or the block's input) and the sum, Smish,
optionally a max-pool. Smish itself, and the wrapper and launch count of
the ``local_epilogue`` kernel (``csrc/local_epilogue.cu``), which computes
that tail in one pass.

The kernel takes a junction where ``fuses`` holds: a float32 CUDA input
whose norms are in eval mode, with autograd off (the estimators,
``local_tokens`` in the global pre-calculation, the densify trainer's
pipeline). ``local_epilogue`` then runs the convolutions without their bias
(PyTorch adds a cuDNN convolution's bias in a pass of its own; the kernel
adds it, rounded as that pass rounds it), and the kernel reads their
outputs once and writes the next layer's input once. Anything else (the
CPU, bfloat16, train mode with its batch statistics, autograd) runs the
modules' own chain, ``models/local_stage.py::local_epilogue_plain``, which
is also the oracle the kernel is held against on the card.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ._launch import check, raise_on, stream

_LAUNCHES = {"local_epilogue": 0}

# floats a block of the kernel takes, at most (the fastest of 4,096 to
# 32,768 at most junctions on an H100, PERF.md)
TILE_FLOATS = 16384


def smish(x):
    """Smish(x) = x * tanh(log(1 + sigmoid(x))), the CNN's activation; in
    float32 the kernel computes it to the bit. In bfloat16 the sigmoid is
    1 / (1 + exp(-x)) with each operation rounded, as XLA expands Flax's
    ``nn.sigmoid`` (torch.sigmoid would round once)."""
    if x.dtype != torch.bfloat16:
        return x * torch.tanh(torch.log1p(torch.sigmoid(x)))
    return x * torch.tanh(torch.log1p(1.0 / (1.0 + torch.exp(-x))))


class Smish(nn.Module):
    def forward(self, x):
        return smish(x)


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel name."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def fuses(x, *modules) -> bool:
    """True where the kernel takes the chain: a float32 input on a CUDA
    device, every module in eval mode and computing in float32 (a layer's
    ``compute_dtype``, ``models/layers.py``), autograd off."""
    return (x.device.type == "cuda" and x.dtype == torch.float32
            and not torch.is_grad_enabled()
            and all(not m.training and getattr(m, "compute_dtype", torch.float32) == torch.float32
                    for m in modules))


def _unbiased(layer, x):
    """(the layer's output without a convolution's bias, that bias or None).
    A convolution's output channels-last: cuDNN writes it so from the CNN's
    channels-last input, PyTorch's own convolution (cuDNN off) NCHW, which
    is copied. A linear layer keeps its bias: cuBLAS adds it inside the
    product."""
    if isinstance(layer, nn.Conv2d):
        y = layer._conv_forward(x, layer.weight, None)
        return y.contiguous(memory_format=torch.channels_last), layer.bias
    return layer(x), None


def local_epilogue(layer, x, norm, skip=None, pool=None):
    """``smish(norm(layer(x)) + skip)``, then a max-pool, through the
    kernel: the tail after a layer where ``fuses`` holds for x and the
    modules. ``skip``: None, a tensor added as it is, or (layer, input,
    norm) of a residual branch, ``norm(layer(input))``; ``pool``: (kernel,
    stride, padding) or None."""
    y, bias = _unbiased(layer, x)
    residual, residual_norm, residual_bias = skip, None, None
    if isinstance(skip, tuple):
        (residual, residual_bias), residual_norm = _unbiased(skip[0], skip[1]), skip[2]
    return local_epilogue_cuda(y, norm, residual, residual_norm, pool, bias=bias,
                               residual_bias=residual_bias)


def _norm_args(bias, norm, C: int, dev) -> list:
    """The C arguments of a convolution's bias and its BatchNorm."""
    if norm is None:   # the residual's, added as it is
        if bias is not None:
            raise ValueError("local_epilogue_cuda: a residual bias without a residual norm")
        return [None] * 5 + [0.0]
    if norm.weight is None or norm.running_mean is None:
        raise ValueError("local_epilogue_cuda: the BatchNorm needs affine parameters and "
                         "running statistics")
    ts = (bias, norm.weight, norm.bias, norm.running_mean, norm.running_var)
    for name, t in zip(("bias", "weight", "norm bias", "running_mean", "running_var"), ts):
        if t is None:
            continue
        check(name, t, (C,))
        if t.device != dev:
            raise ValueError(f"{name}: on {t.device}, the input on {dev}")
    return [None if t is None else t.data_ptr() for t in ts] + [float(norm.eps)]


def channels_per_block(C: int, H: int, W: int) -> int:
    """With a pool: the channels of an image a block takes, the largest
    multiple of 4 dividing C with at most TILE_FLOATS floats (at least 4)."""
    fits = [cb for cb in range(4, C + 1, 4) if C % cb == 0 and cb * H * W <= TILE_FLOATS]
    return max(fits, default=4)


def local_epilogue_cuda(x, norm, residual=None, residual_norm=None, pool=None, *,
                        bias=None, residual_bias=None):
    """The kernel: ``local_epilogue_plain(x + bias, norm, residual +
    residual_bias, residual_norm, pool)`` (``models/local_stage.py``), each
    bias (C,) or None. x (N, C, H, W) channels-last, as the CNN's
    convolutions write it, or (N, C) contiguous, float32 on a CUDA card,
    16-byte aligned, C a multiple of 4; ``residual`` of x's shape and
    strides; the biases and the norms' tensors (C,) float32 on the same
    card. Returns a new tensor: x's shape and layout, or (N, C, Ho, Wo)
    channels-last after the pool. A block takes TILE_FLOATS floats, or with
    a pool ``channels_per_block`` channels of an image."""
    if x.device.type != "cuda":
        raise ValueError(f"local_epilogue_cuda: expected a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"local_epilogue_cuda: expected float32, got {x.dtype}")
    if x.dim() not in (2, 4):
        raise ValueError(f"local_epilogue_cuda: expected (N, C) or (N, C, H, W), "
                         f"got {tuple(x.shape)}")
    if norm is None:
        raise ValueError("local_epilogue_cuda: x needs its BatchNorm")
    N, C = x.shape[:2]
    H, W = x.shape[2:] if x.dim() == 4 else (1, 1)
    if C % 4:
        raise ValueError(f"local_epilogue_cuda: channels must be a multiple of 4, got {C}")
    if not x.is_contiguous(memory_format=torch.channels_last if x.dim() == 4
                           else torch.contiguous_format):
        raise ValueError(f"local_epilogue_cuda: x must be channels-last (or (N, C) "
                         f"contiguous), strides {x.stride()}")
    if residual is not None:
        if residual.shape != x.shape or residual.stride() != x.stride():
            raise ValueError(f"residual: shape {tuple(residual.shape)} and strides "
                             f"{residual.stride()}, x {tuple(x.shape)} and {x.stride()}")
        if residual.dtype != torch.float32 or residual.device != x.device:
            raise ValueError("residual: must be float32 on x's device")
    elif residual_norm is not None:
        raise ValueError("local_epilogue_cuda: a residual norm without a residual")
    for name, t in (("x", x), ("residual", residual)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name}: must start on 16 bytes")
    shape = tuple(x.shape)
    k = s = p = 0
    if pool is not None:
        if x.dim() != 4:
            raise ValueError("local_epilogue_cuda: a pool needs (N, C, H, W)")
        k, s, p = pool
        if not (k > 0 and s > 0 and 0 <= p <= k // 2 and k <= H + 2 * p and k <= W + 2 * p):
            raise ValueError(f"local_epilogue_cuda: unsupported pool {pool}")
        shape = (N, C, (H + 2 * p - k) // s + 1, (W + 2 * p - k) // s + 1)
    out = torch.empty(shape, dtype=torch.float32, device=x.device,
                      memory_format=torch.channels_last if x.dim() == 4 else
                      torch.contiguous_format)
    from ._build import load_library

    rc = load_library().cdll.local_epilogue_launch(
        x.data_ptr(), *_norm_args(bias, norm, C, x.device),
        None if residual is None else residual.data_ptr(),
        *_norm_args(residual_bias, residual_norm, C, x.device),
        out.data_ptr(), N, C, H, W, k, s, p, TILE_FLOATS,
        channels_per_block(C, H, W), stream(x))
    raise_on(rc, "local_epilogue")
    _LAUNCHES["local_epilogue"] += 1
    return out
