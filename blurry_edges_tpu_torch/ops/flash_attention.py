"""Flash attention: exact softmax attention without the L x L probabilities
in device memory, forward and backward.

Replaces the library TPU kernels behind the JAX package's
``models/global_stage.py::flash_attention_fn``
(``jax.experimental.pallas.ops.tpu.flash_attention``: the forward, the
dK/dV backward and the dQ backward). CUDA sources: ``csrc/flash_attn_fwd.cu``
(``flash_fwd``), ``csrc/flash_attn_bwd_dkv.cu`` (``flash_bwd_dkv``) and
``csrc/flash_attn_bwd_dq.cu`` (``flash_bwd_dq``), all three on the tensor
cores in 3xTF32 (``csrc/flash_mma.cuh``).

Layout (B, H, L, D) float32, contiguous, D = 16, as the JAX function moves
its operands to. A wrapper given CUDA tensors checks them and launches its
kernel on the current stream, or raises; given CPU tensors it runs its plain
PyTorch version (``flash_attention_plain``, ``flash_attention_bwd_plain``),
which is also the oracle the kernels are held against on the card.
``flash_attention`` is the differentiable entry, a ``torch.autograd.Function``
that saves q, k, v, o and lse and runs the two backward kernels (or the
plain backward on the CPU). No bias, no mask, no dropout.
"""

from __future__ import annotations

import torch

from ._launch import check, device_type, raise_on, stream

HEAD_DIM = 16  # the only head dim the kernels are built for

_LAUNCHES = {"flash_fwd": 0, "flash_bwd_dkv": 0, "flash_bwd_dq": 0}


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel name."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


# --------------------------------------------------------------- plain


def flash_attention_plain(q, k, v, scale: float):
    """Plain PyTorch attention: q, k, v (B, H, L, D) -> (o (B, H, L, D),
    lse (B, H, L)), lse the log-sum-exp of each row of scale * q k^T."""
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    lse = torch.logsumexp(s, dim=-1)
    o = torch.matmul(torch.exp(s - lse[..., None]), v)
    return o, lse


def flash_attention_bwd_plain(q, k, v, o, lse, dout, scale: float):
    """Plain PyTorch backward of ``flash_attention_plain``'s o, with the
    probabilities materialised: -> (dq, dk, dv)."""
    p = torch.exp(torch.matmul(q, k.transpose(-1, -2)) * scale - lse[..., None])
    dv = torch.matmul(p.transpose(-1, -2), dout)
    dp = torch.matmul(dout, v.transpose(-1, -2))
    di = (o * dout).sum(-1, keepdim=True)
    ds = p * (dp - di)
    dq = torch.matmul(ds, k) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q) * scale
    return dq, dk, dv


# --------------------------------------------------------------- kernels


def _check_qkv(q, k, v) -> tuple:
    if q.dim() != 4:
        raise ValueError(f"q: expected (B, H, L, D), got {tuple(q.shape)}")
    shape = tuple(q.shape)
    if shape[-1] != HEAD_DIM:
        raise ValueError(f"head dim {shape[-1]}: the kernels take {HEAD_DIM}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check(name, t, shape)
    return shape


def flash_attention_fwd(q, k, v, scale: float):
    """(o, lse) of ``flash_attention_plain``. CUDA tensors: the flash_fwd
    kernel; CPU tensors: the plain version."""
    if device_type(q, k, v) == "cpu":
        return flash_attention_plain(q, k, v, scale)
    B, H, L, D = _check_qkv(q, k, v)
    from ._build import load_library

    o = torch.empty_like(q)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    rc = load_library().cdll.flash_attn_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        B * H, L, float(scale), stream(q))
    raise_on(rc, "flash_fwd")
    _LAUNCHES["flash_fwd"] += 1
    return o, lse


def _check_bwd(q, k, v, dout, lse, di) -> tuple:
    B, H, L, D = _check_qkv(q, k, v)
    check("dout", dout, (B, H, L, D))
    check("lse", lse, (B, H, L))
    check("di", di, (B, H, L))
    return B, H, L, D


def flash_attention_bwd_dkv(q, k, v, dout, lse, di, scale: float):
    """(dk, dv) on CUDA tensors by the flash_bwd_dkv kernel; di is
    rowsum(o * dout), (B, H, L)."""
    B, H, L, D = _check_bwd(q, k, v, dout, lse, di)
    from ._build import load_library

    dk, dv = torch.empty_like(k), torch.empty_like(v)
    rc = load_library().cdll.flash_attn_bwd_dkv_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B * H, L, float(scale), stream(q))
    raise_on(rc, "flash_bwd_dkv")
    _LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


def flash_attention_bwd_dq(q, k, v, dout, lse, di, scale: float):
    """dq on CUDA tensors by the flash_bwd_dq kernel."""
    B, H, L, D = _check_bwd(q, k, v, dout, lse, di)
    from ._build import load_library

    dq = torch.empty_like(q)
    rc = load_library().cdll.flash_attn_bwd_dq_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), di.data_ptr(), dq.data_ptr(), B * H, L, float(scale),
        stream(q))
    raise_on(rc, "flash_bwd_dq")
    _LAUNCHES["flash_bwd_dq"] += 1
    return dq


def flash_attention_bwd(q, k, v, o, lse, dout, scale: float):
    """(dq, dk, dv) of ``flash_attention_bwd_plain``. CUDA tensors: the
    flash_bwd_dkv and flash_bwd_dq kernels, with di = rowsum(o * dout)
    computed beside them; CPU tensors: the plain version."""
    if device_type(q, k, v, o, lse, dout) == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, dout, scale)
    check("o", o, tuple(q.shape))
    di = (o * dout).sum(-1)                                  # (B, H, L)
    dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, di, scale)
    return flash_attention_bwd_dq(q, k, v, dout, lse, di, scale), dk, dv


class FlashAttention(torch.autograd.Function):
    """o = softmax(scale * q k^T) v, with the flash kernels forward and
    backward on CUDA tensors."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        o, lse = flash_attention_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, dout.contiguous(), ctx.scale)
        return dq, dk, dv, None


def flash_attention(q, k, v, scale: float):
    """Differentiable exact attention, q, k, v (B, H, L, 16) -> o."""
    return FlashAttention.apply(q, k, v, scale)
