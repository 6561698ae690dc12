"""The LocalStage's ten junctions as test cases, and the arithmetic that
holds the ``local_epilogue`` kernel to them: shared by
``tests/test_torch_local_epilogue.py`` and ``chip_smoke.py``. Draws come
from the generator given, on its own device."""

import torch
import torch.nn.functional as F

from blurry_edges_tpu_torch.models.batchnorm import BatchNorm1d, BatchNorm2d
from blurry_edges_tpu_torch.ops.local_epilogue import smish

# name: (channels, side, residual, pool) of each of the LocalStage's ten
# junctions (side 0: the head's (N, 1024) BatchNorm1d)
JUNCTIONS = {
    "conv1": (64, 21, False, (3, 2, 1)),
    "layer0.conv1": (96, 11, False, None),
    "layer0.sum": (96, 11, True, (3, 2, 1)),
    "layer1.conv1": (256, 6, False, None),
    "layer1.sum": (256, 6, True, None),
    "layer2.conv1": (384, 6, False, None),
    "layer2.sum": (384, 6, True, None),
    "layer3.conv1": (256, 6, False, None),
    "layer3.sum": (256, 6, True, (2, 2, 0)),
    "fc": (1024, 0, False, None),
}


def make_norm(C: int, side: int, g: torch.Generator, trivial: bool = False):
    """An eval-mode BatchNorm of C channels, with random affine parameters
    and running statistics (``trivial``: a fresh one's, weight 1, bias 0,
    mean 0, variance 1, as the benchmark's weights have)."""
    bn = (BatchNorm2d if side else BatchNorm1d)(C)
    if not trivial:
        with torch.no_grad():
            bn.weight.copy_(torch.randn(C, generator=g, device=g.device) * 0.5 + 1.0)
            bn.bias.copy_(torch.randn(C, generator=g, device=g.device) * 0.3)
            bn.running_mean.copy_(torch.randn(C, generator=g, device=g.device) * 0.4)
            bn.running_var.copy_(torch.rand(C, generator=g, device=g.device) * 2.0 + 0.05)
    return bn.eval()


def junction(name: str, N: int, g: torch.Generator, device="cpu", trivial=False,
             dtype=torch.float32):
    """Inputs of one junction: dict(x, norm, residual, residual_norm, pool).
    Images are channels-last, as the LocalStage's convolutions write them
    (its NHWC input permuted to NCHW)."""
    C, side, res, pool = JUNCTIONS[name]
    shape = (N, C, side, side) if side else (N, C)
    fmt = torch.channels_last if side else torch.contiguous_format

    def draw():
        t = torch.randn(shape, generator=g, device=g.device) * 1.5
        return t.to(device, dtype).contiguous(memory_format=fmt)

    args = dict(x=draw(), norm=make_norm(C, side, g, trivial).to(device), residual=None,
                residual_norm=None, pool=pool)
    if res:
        args["residual"] = draw()
        args["residual_norm"] = make_norm(C, side, g, trivial).to(device)
    return args


def conv_biases(a: dict, g: torch.Generator) -> dict:
    """Random convolution biases for x (and the residual), as keywords of
    ``local_epilogue_cuda``."""
    C, dev = a["x"].shape[1], a["x"].device
    out = dict(bias=(torch.randn(C, generator=g, device=g.device) * 0.5).to(dev))
    if a["residual"] is not None:
        out["residual_bias"] = (torch.randn(C, generator=g, device=g.device) * 0.5).to(dev)
    return out


def biased(t, bias):
    """t plus a convolution's bias, as PyTorch adds it after cuDNN's convolution."""
    return t if bias is None else t + bias.view([1, -1] + [1] * (t.dim() - 2))


def _affine(norm, t):
    shape = [1, -1] + [1] * (t.dim() - 2)
    return [v.view(shape) for v in (norm.running_mean, norm.weight, norm.running_var,
                                    norm.bias)]


def fma32(a, b, c):
    """float32 fma(a, b, c), rounded once: the product is exact in float64,
    the float64 sum's own rounding error (TwoSum) breaks float32 ties."""
    p = a.double() * b.double()
    c = c.double()
    t = p + c
    bb = t - p
    e = (p - (t - bb)) + (c - bb)
    f = t.float()
    diff = t - f.double()
    nb = torch.nextafter(f, torch.where(diff > 0, torch.inf, -torch.inf).float())
    tie = (diff != 0) & (diff.abs() * 2 == (nb.double() - f.double()).abs())
    # t sits halfway between f and nb: the exact sum t + e lies past the
    # midpoint (nb) where e points away from f, else on f's side (f)
    return torch.where(tie & (e != 0) & ((e > 0) == (diff > 0)), nb, f)


def kernel_norm(norm, x):
    """The kernel's BatchNorm (of x with the convolution's bias added) in
    PyTorch's float32 operations:
    fma(x - mean, weight * rsqrt(var + eps), bias)."""
    mean, w, var, b = _affine(norm, x)
    scale = w * torch.rsqrt(var + norm.eps)
    return fma32(x - mean, scale.expand_as(x), b.expand_as(x))


def exact_norm(norm, x):
    """That BatchNorm in float64 from the same float32 scale: (x - mean) *
    scale + bias, rounded nowhere."""
    mean, w, var, b = _affine(norm, x)
    scale = w * torch.rsqrt(var + norm.eps)
    return (x.double() - mean.double()) * scale.double() + b.double()


def norm_size(norm, x):
    """The size a BatchNorm's arithmetic works at, element by element: the
    largest of |x - mean| |scale|, |mean| |scale| and |bias|."""
    mean, w, var, b = _affine(norm, x)
    scale = (w * torch.rsqrt(var + norm.eps)).abs()
    return torch.maximum(torch.maximum((x - mean).abs() * scale, mean.abs() * scale), b.abs())


def ulp(t):
    """The float32 spacing above |t|."""
    t = t.abs().float()
    return torch.nextafter(t, torch.full_like(t, torch.inf)) - t


def kernel_errors(got, a: dict, biases: dict, chunk: int = 2048):
    """The kernel's output ``got`` at junction ``a`` (``junction``) with
    convolution biases ``biases`` (``conv_biases``), ``chunk`` images at a
    time: (whether it equals Smish and the pool on the kernel's own
    BatchNorm to the bit, the largest distances in float32 ulps of the size
    the BatchNorm and the sum work at: {"exact": the kernel's from the exact
    one on the same float32 scale, "cudnn": from the modules' (cuDNN's
    inference BatchNorm, then the add), "cudnn_exact": the modules' from the
    exact}). The roundings of x - mean and of the fma bound "exact" by 2
    ulps a BatchNorm, 6 with a sum."""
    x, norm, r, rn, pool = a["x"], a["norm"], a["residual"], a["residual_norm"], a["pool"]
    b, rb = biases["bias"], biases.get("residual_bias")
    errs = {"exact": 0.0, "cudnn": 0.0, "cudnn_exact": 0.0}
    equal = True
    with torch.no_grad():
        for i in range(0, x.shape[0], chunk):
            part = slice(i, i + chunk)
            xb = biased(x[part], b)
            ours, theirs = kernel_norm(norm, xb), norm(xb)
            exact, size_ = exact_norm(norm, xb), norm_size(norm, xb)
            if r is not None:
                rbp = biased(r[part], rb)
                ours = ours + kernel_norm(rn, rbp)
                theirs = theirs + rn(rbp)
                exact = exact + exact_norm(rn, rbp)
                size_ = torch.maximum(size_, norm_size(rn, rbp))
            unit = ulp(size_).double()
            for k, v in (("exact", ours.double() - exact), ("cudnn", ours - theirs),
                         ("cudnn_exact", theirs.double() - exact)):
                errs[k] = max(errs[k], (v.abs() / unit).max().item())
            want = smish(ours)
            if pool is not None:
                want = F.max_pool2d(want, *pool)
            equal = equal and torch.equal(got[part], want)
    return equal, errs
