"""The port's CUDA kernels against their plain versions, on a CUDA card.

Every test here needs a CUDA device and skips without one. On a machine
with a card, from the repository root (tests/conftest.py imports JAX, which
that machine need not have, hence --noconftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances as chip_smoke.py states them: colors rtol 2e-3 / atol 2e-4;
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


FLASH_SCALE = 0.25  # 1/sqrt(16)


def assert_flash_close(got, want, tol):
    for g, w in zip(got, want):
        g = g.cpu()
        assert torch.isfinite(g).all()
        scale = max(1.0, w.abs().max().item())
        assert (g - w.cpu()).abs().max().item() < tol * scale


@pytest.mark.parametrize("shape", [(2, 8, 4096, 16), (1, 8, 121, 16), (3, 2, 1, 16),
                                   (1, 1, 200, 16)])
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
