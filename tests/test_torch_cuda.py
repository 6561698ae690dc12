"""The port's CUDA kernels against their plain versions, on a CUDA card.

Every test here needs a CUDA device and skips without one. On a machine
with a card, from the repository root (tests/conftest.py imports JAX, which
that machine need not have, hence --noconftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances as chip_smoke.py states them: colors rtol 2e-3 / atol 2e-4;
the pp estimator's U-Net as tests/test_torch_pipeline.py holds it;
render p99.9 |diff| < 1e-3 * scale, under 2e-3 of the entries off by more
than 0.01 * scale, under 1e-3 of the mask flipped; flash attention max
|diff| under 1e-5 * scale for o and lse and 1e-4 * scale for the gradients
(scale: the largest |value| of the plain result, at least 1; float32 on
both sides, summed in another order).
"""

import numpy as np
import pytest
import torch

from blurry_edges_tpu_torch.config import CamConfig, GridConfig, PatchConfig
from blurry_edges_tpu_torch.eval.pipeline import make_depth_estimator
from blurry_edges_tpu_torch.models.global_stage import SelfAttention
from blurry_edges_tpu_torch.ops import flash_attention as fa
from blurry_edges_tpu_torch.ops import wedge_cuda
from blurry_edges_tpu_torch.ops.dfd import DfDSolver
from blurry_edges_tpu_torch.ops.wedge import params2etas
from blurry_edges_tpu_torch.utils.device import float32_precision
from blurry_edges_tpu_torch.utils.weights import random_modules

pytestmark = pytest.mark.cuda

PATCH = PatchConfig()
DFD = DfDSolver.from_config(CamConfig(), PATCH)
R = PATCH.R


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def render_inputs(g, B, Hp, Wp):
    xy = torch.cat([torch.rand((B, Hp, Wp, 4), generator=g) * 1.6 - 0.8,
                    torch.rand((B, Hp, Wp, 4), generator=g) * 2 * np.pi], -1)
    etas = params2etas(torch.randn((B, Hp, Wp, 4), generator=g))
    imgs = torch.rand((B, 2, Hp, Wp, R, R, 3), generator=g)
    return xy, etas, imgs


def assert_render_close(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].cpu()
        w = w.cpu()
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if k == "depth_mask":
            assert (g != w).float().mean().item() < 1e-3, k
            continue
        assert torch.isfinite(g).all(), k
        d = (g - w).abs().flatten()
        scale = max(1.0, w.abs().max().item())
        assert torch.quantile(d, 0.999).item() < 1e-3 * scale, k
        assert (d > 0.01 * scale).float().mean().item() < 2e-3, k


@pytest.mark.parametrize("degenerate", [False, True])
def test_colors_kernel_matches_plain(dev, degenerate):
    g = torch.Generator().manual_seed(3)
    P = 1000
    params = torch.randn((P, 10), generator=g) * 1.5
    if degenerate:
        params = torch.zeros((P, 10))
        params[:, 8:] = 2.0
    pixels = torch.rand((P, R, R, 3), generator=g)
    before = wedge_cuda.launch_counts()["wedge_colors"]
    got = wedge_cuda.wedge_colors(params.to(dev), pixels.to(dev), PATCH)
    torch.cuda.synchronize()
    assert wedge_cuda.launch_counts()["wedge_colors"] == before + 1
    assert torch.isfinite(got).all()
    want = wedge_cuda.wedge_colors_plain(params, pixels, PATCH)
    torch.testing.assert_close(got.cpu(), want, rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_colors_kernel_matches_plain_ragged_unaligned(dev, offset):
    """P = 4,097 (the last block of warps holds one patch), the pixels
    starting ``offset`` floats into their buffer: the kernel copies each
    5,292-byte patch in by 16-byte chunks with 4-byte ends, and every
    patch's start lands in each 4-byte class of 16 over the patches."""
    g = torch.Generator().manual_seed(11 + offset)
    P = 4097
    params = torch.randn((P, 10), generator=g) * 1.5
    buf = torch.rand((P * R * R * 3 + offset,), generator=g)
    pixels = buf[offset:].view(P, R, R, 3)
    on_card = buf.to(dev)[offset:].view(P, R, R, 3)
    got = wedge_cuda.wedge_colors(params.to(dev), on_card, PATCH)
    torch.cuda.synchronize()
    want = wedge_cuda.wedge_colors_plain(params, pixels, PATCH)
    torch.testing.assert_close(got.cpu(), want, rtol=2e-3, atol=2e-4)


def test_colors_kernel_repeats_bit_for_bit(dev):
    """Each patch's sums in a fixed order: a second launch gives the same
    bits."""
    g = torch.Generator().manual_seed(12)
    params = (torch.randn((2049, 10), generator=g) * 1.5).to(dev)
    pixels = torch.rand((2049, R, R, 3), generator=g).to(dev)
    first = wedge_cuda.wedge_colors(params, pixels, PATCH)
    again = wedge_cuda.wedge_colors(params, pixels, PATCH)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


@pytest.mark.parametrize("hard", [False, True])
@pytest.mark.parametrize("degenerate", [False, True])
def test_render_kernel_matches_plain(dev, hard, degenerate):
    g = torch.Generator().manual_seed(4)
    xy, etas, imgs = render_inputs(g, 2, 5, 7)
    if degenerate:
        xy, etas = torch.zeros_like(xy), torch.full_like(etas, 0.01)
    args = (PATCH, DFD, 10.39, hard)
    got = wedge_cuda.wedge_render(xy.to(dev), etas.to(dev), imgs.to(dev), *args)
    torch.cuda.synchronize()
    assert_render_close(got, wedge_cuda.wedge_render_plain(xy, etas, imgs, *args))


@pytest.mark.parametrize("hard", [False, True])
def test_render_kernel_matches_plain_ragged(dev, hard):
    """Three pairs of the 587x587 path's 41x41 blocks, 11x11 patches each
    (P = 363): patches' ranges start off 16 bytes (5,292 B a patch) and the
    last block of warps is short."""
    g = torch.Generator().manual_seed(9)
    xy, etas, imgs = render_inputs(g, 3, 11, 11)
    args = (PATCH, DFD, 10.39, hard)
    got = wedge_cuda.wedge_render(xy.to(dev), etas.to(dev), imgs.to(dev), *args)
    torch.cuda.synchronize()
    assert_render_close(got, wedge_cuda.wedge_render_plain(xy, etas, imgs, *args))


def test_render_kernel_repeats_bit_for_bit(dev):
    """Every sum of the render in a fixed order: a second launch gives the
    same bits."""
    g = torch.Generator().manual_seed(10)
    xy, etas, imgs = (t.to(dev) for t in render_inputs(g, 2, 9, 13))
    first = wedge_cuda.wedge_render(xy, etas, imgs, PATCH, DFD, 10.39, False)
    again = wedge_cuda.wedge_render(xy, etas, imgs, PATCH, DFD, 10.39, False)
    torch.cuda.synchronize()
    for k in first:
        assert torch.equal(first[k], again[k]), k


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    params = torch.zeros((4, 10), device=dev)
    pixels = torch.zeros((4, R, R, 3), device=dev)
    with pytest.raises(TypeError):
        wedge_cuda.wedge_colors(params.double(), pixels, PATCH)
    with pytest.raises(ValueError, match="contiguous"):
        wedge_cuda.wedge_colors(torch.zeros((10, 4), device=dev).t(), pixels, PATCH)
    with pytest.raises(ValueError, match="shape"):
        wedge_cuda.wedge_colors(params, pixels[:3], PATCH)
    with pytest.raises(ValueError, match="several devices"):
        wedge_cuda.wedge_colors(params, pixels.cpu(), PATCH)


def test_estimator_on_the_card_launches_both_kernels(dev):
    mods = random_modules(torch.Generator().manual_seed(0), dev)
    grid = GridConfig(H=41, W=41)
    img = torch.rand((2, 41, 41, 3), generator=torch.Generator().manual_seed(5))
    wedge_cuda.reset_launch_counts()
    out = make_depth_estimator(mods, PATCH, grid, CamConfig(), device=dev)(img)
    torch.cuda.synchronize()
    assert wedge_cuda.launch_counts() == {"wedge_colors": 1, "wedge_render": 1}
    for k, v in out.items():
        assert v.device.type == "cuda" and torch.isfinite(v).all(), k


def test_pp_estimator_on_the_card_matches_the_cpu(dev):
    """densify pp at 41x41: the card (both wedge kernels once each, the
    U-Net by cuDNN in float32) against the port on the CPU (the plain
    versions). The maps before the densify as chip_smoke.py holds them; the
    U-Net fed the CPU's global depth gives the CPU's depth_final to rtol
    1e-4 (atol 1e-4 x scale), and end to end p90 |diff| < 5e-3 (a
    knife-edge pixel of global_depth spreads over the U-Net's receptive
    field, tests/test_torch_pipeline.py::assert_pp_depth_close)."""
    mods_cpu = random_modules(torch.Generator().manual_seed(0), "cpu", unet=True)
    mods = random_modules(torch.Generator().manual_seed(0), dev, unet=True)
    grid = GridConfig(H=41, W=41)
    img = torch.rand((2, 41, 41, 3), generator=torch.Generator().manual_seed(6))
    wedge_cuda.reset_launch_counts()
    got = make_depth_estimator(mods, PATCH, grid, CamConfig(), densify="pp", device=dev)(img)
    torch.cuda.synchronize()
    assert wedge_cuda.launch_counts() == {"wedge_colors": 1, "wedge_render": 1}
    want = make_depth_estimator(mods_cpu, PATCH, grid, CamConfig(), densify="pp",
                                device="cpu")(img)
    for k in ("global_image", "global_shpd", "global_bndry"):
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=5e-3, atol=5e-3)
    for k in ("global_depth", "confidence"):
        assert torch.quantile((got[k].cpu() - want[k]).abs().flatten(), 0.99).item() < 5e-3, k
    scale = want["depth_final"].abs().max().item()
    with torch.inference_mode(), float32_precision():
        fed = mods.unet_model(want["global_depth"][:, None].to(dev))[:, 0].cpu()
    torch.testing.assert_close(fed, want["depth_final"], rtol=1e-4, atol=1e-4 * scale)
    d = (got["depth_final"].cpu() - want["depth_final"]).abs().flatten()
    assert torch.quantile(d, 0.9).item() < 5e-3 and d.max().item() < 0.25 * scale


FLASH_SCALE = 0.25  # 1/sqrt(16)


def assert_flash_close(got, want, tol):
    for g, w in zip(got, want):
        g = g.cpu()
        assert torch.isfinite(g).all()
        scale = max(1.0, w.abs().max().item())
        assert (g - w.cpu()).abs().max().item() < tol * scale


@pytest.mark.parametrize("shape", [(2, 8, 4096, 16), (1, 8, 121, 16), (3, 2, 1, 16),
                                   (1, 1, 200, 16), (1, 2, 4097, 16), (2, 1, 64, 16)])
def test_flash_kernels_match_plain(dev, shape):
    g = torch.Generator().manual_seed(shape[2])
    q, k, v, dout = (torch.randn(shape, generator=g).to(dev) for _ in range(4))
    fa.reset_launch_counts()
    o, lse = fa.flash_attention_fwd(q, k, v, FLASH_SCALE)
    o_p, lse_p = fa.flash_attention_plain(q, k, v, FLASH_SCALE)
    assert_flash_close((o, lse), (o_p, lse_p), 1e-5)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, dout, FLASH_SCALE)
    torch.cuda.synchronize()
    assert_flash_close(grads, fa.flash_attention_bwd_plain(q, k, v, o_p, lse_p, dout,
                                                           FLASH_SCALE), 1e-4)
    assert fa.launch_counts() == {"flash_fwd": 1, "flash_bwd_dkv": 1, "flash_bwd_dq": 1}


def test_tensor_core_flash_kernels_repeat_bit_for_bit(dev):
    """The forward, dK/dV and dQ kernels (tensor cores, 3xTF32) give the
    same bits on a second launch: every sum in a fixed order, no atomics."""
    g = torch.Generator().manual_seed(12)
    q, k, v, dout = (torch.randn((1, 2, 4097, 16), generator=g).to(dev) for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v, FLASH_SCALE)
    di = (o * dout).sum(-1)
    first = (o, lse, *fa.flash_attention_bwd_dkv(q, k, v, dout, lse, di, FLASH_SCALE),
             fa.flash_attention_bwd_dq(q, k, v, dout, lse, di, FLASH_SCALE))
    again = (*fa.flash_attention_fwd(q, k, v, FLASH_SCALE),
             *fa.flash_attention_bwd_dkv(q, k, v, dout, lse, di, FLASH_SCALE),
             fa.flash_attention_bwd_dq(q, k, v, dout, lse, di, FLASH_SCALE))
    torch.cuda.synchronize()
    for x, y in zip(first, again):
        assert torch.equal(x, y)


def test_flash_function_backward_matches_autograd(dev):
    """The Function's kernel backward against autograd through plain
    attention, and its gradients against finite differences in float64
    through the plain attention on the CPU (gradcheck of the formula the
    kernels implement; the kernels take float32 only)."""
    g = torch.Generator().manual_seed(7)
    q, k, v, dout = (torch.randn((2, 8, 300, 16), generator=g).to(dev) for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.flash_attention(*leaves, FLASH_SCALE).backward(dout)
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    torch.softmax(ref[0] @ ref[1].transpose(-1, -2) * FLASH_SCALE, -1).matmul(ref[2]).backward(dout)
    assert_flash_close([t.grad for t in leaves], [t.grad for t in ref], 1e-4)
    small = [torch.randn((1, 2, 9, 16), generator=g, dtype=torch.float64).requires_grad_()
             for _ in range(3)]
    assert torch.autograd.gradcheck(
        lambda a, b, c: fa.FlashAttention.apply(a, b, c, FLASH_SCALE), small)


def test_flash_self_attention_on_the_card_uses_the_kernels(dev):
    x = torch.randn((2, 121, 128), generator=torch.Generator().manual_seed(8)).to(dev)
    xla = SelfAttention(128, 8, attn_impl="xla").to(dev)
    flash = SelfAttention(128, 8, attn_impl="flash").to(dev)
    flash.load_state_dict(xla.state_dict())
    fa.reset_launch_counts()
    outs = []
    for mod in (xla, flash):
        xi = x.clone().requires_grad_()
        with float32_precision():
            out = mod(xi)
            out.square().sum().backward()
        outs.append((out.detach(), xi.grad))
    torch.cuda.synchronize()
    assert fa.launch_counts() == {"flash_fwd": 1, "flash_bwd_dkv": 1, "flash_bwd_dq": 1}
    assert_flash_close(outs[1], outs[0], 1e-4)


def test_flash_wrappers_reject_what_the_kernels_do_not_take(dev):
    q = torch.zeros((1, 8, 64, 16), device=dev)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_fwd(*(torch.zeros((1, 8, 64, 32), device=dev),) * 3, 0.25)
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(q.double(), q.double(), q.double(), 0.25)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_fwd(q.transpose(1, 2).contiguous().transpose(1, 2), q, q, 0.25)
    with pytest.raises(ValueError, match="shape"):
        fa.flash_attention_fwd(q, q[:, :, :32].contiguous(), q, 0.25)
