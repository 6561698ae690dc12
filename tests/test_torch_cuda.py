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
from blurry_edges_tpu_torch.models.weights import random_modules

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


def test_kernels_at_the_big_paths_chunk_shapes(dev):
    """A chunk of 6 blocks of the 587x587 path: colors over 6 x 8,192
    patches and the render over B = 6 blocks of 64x64 patches with soft
    masks, each launched once, against the plain versions (run on the card
    one block at a time)."""
    g = torch.Generator().manual_seed(21)
    c = 6
    xy, etas, imgs = (t.to(dev) for t in render_inputs(g, c, 64, 64))
    params = (torch.randn((c * 8192, 10), generator=g) * 1.5).to(dev)
    pixels = imgs.permute(0, 2, 3, 1, 4, 5, 6).reshape(c * 8192, R, R, 3).contiguous()
    colors = wedge_cuda.wedge_colors(params, pixels, PATCH)
    rend = wedge_cuda.wedge_render(xy, etas, imgs, PATCH, DFD, 10.39, False)
    for i in range(0, c * 8192, 8192):
        s = slice(i, i + 8192)
        torch.testing.assert_close(colors[s], wedge_cuda.wedge_colors_plain(
            params[s], pixels[s], PATCH), rtol=2e-3, atol=2e-4)
    for b in range(c):
        want = wedge_cuda.wedge_render_plain(xy[b:b + 1], etas[b:b + 1], imgs[b:b + 1],
                                             PATCH, DFD, 10.39, False)
        assert_render_close({k: v[b:b + 1] for k, v in rend.items()}, want)


def test_kernels_repeat_bit_for_bit_at_36_blocks(dev):
    """All 36 blocks in one chunk: colors over P = 36 x 8,192 and the render
    over B = 36, launched twice, the same bits."""
    g = torch.Generator(device=dev).manual_seed(22)
    P = 36 * 8192
    params = torch.randn((P, 10), generator=g, device=dev) * 1.5
    pixels = torch.rand((P, R, R, 3), generator=g, device=dev)
    first = wedge_cuda.wedge_colors(params, pixels, PATCH)
    again = wedge_cuda.wedge_colors(params, pixels, PATCH)
    assert torch.equal(first, again)
    del first, again
    xy = torch.cat([torch.rand((36, 64, 64, 4), generator=g, device=dev) * 1.6 - 0.8,
                    torch.rand((36, 64, 64, 4), generator=g, device=dev) * 2 * np.pi], -1)
    etas = params2etas(torch.randn((36, 64, 64, 4), generator=g, device=dev))
    imgs = pixels.view(36, 2, 64, 64, R, R, 3)   # 36 x 2 x 4,096 = P patches
    first = wedge_cuda.wedge_render(xy, etas, imgs, PATCH, DFD, 10.39, False)
    again = wedge_cuda.wedge_render(xy, etas, imgs, PATCH, DFD, 10.39, False)
    torch.cuda.synchronize()
    for k in first:
        assert torch.equal(first[k], again[k]), k


def test_bf16_estimator_on_the_card_matches_the_cpu(dev):
    """Networks in bfloat16 at 41x41: each network's bfloat16 output on the
    card is no further from the float32 output than 1.25 times the CPU's
    bfloat16 output is (p99 and max), and within twice that of the CPU's
    bfloat16 output. cuDNN and oneDNN sum each product in another order, so
    single bfloat16 roundings fall apart and spread: the card and the CPU
    differ by bfloat16 roundings as bfloat16 and float32 do (on an H100 the
    global stage's p99 is 0.0137 card vs CPU against 0.0133 bfloat16 vs
    float32), so the card's own bfloat16 error is what is bounded. The estimator's maps are float32, finite, from one launch of
    each kernel."""
    from blurry_edges_tpu_torch.ops.patchify import unfold

    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    cpu32 = random_modules(gen(), "cpu", unet=True)
    cpu16 = random_modules(gen(), "cpu", unet=True, dtype=torch.bfloat16)
    card16 = random_modules(gen(), dev, unet=True, dtype=torch.bfloat16)
    img = torch.rand((2, 41, 41, 3), generator=torch.Generator().manual_seed(7))
    flat = unfold(img, R, 2).reshape(-1, R, R, 3)
    src = torch.randn((1, 121, 38), generator=torch.Generator().manual_seed(8))
    depth = torch.rand((1, 1, 41, 41), generator=torch.Generator().manual_seed(9)) + 0.5
    with torch.inference_mode():
        for name, x in (("local_model", flat), ("global_model", src), ("unet_model", depth)):
            want16 = getattr(cpu16, name)(x).float()
            want32 = getattr(cpu32, name)(x)
            got = getattr(card16, name)(x.to(dev)).float().cpu()
            ref = (want16 - want32).abs().flatten()
            d = (got - want16).abs().flatten()
            own = (got - want32).abs().flatten()
            for q, (e_card, e_cpu, e_pair) in (
                    ("p99", (torch.quantile(t, 0.99).item() for t in (own, ref, d))),
                    ("max", (t.max().item() for t in (own, ref, d)))):
                print(name, q, "card bf16 - f32", e_card, "cpu bf16 - f32", e_cpu,
                      "card - cpu bf16", e_pair)
                assert e_card <= 1.25 * e_cpu and e_pair <= 2 * e_cpu, (name, q)
    wedge_cuda.reset_launch_counts()
    out = make_depth_estimator(card16, PATCH, GridConfig(H=41, W=41), CamConfig(),
                               device=dev)(img)
    torch.cuda.synchronize()
    assert wedge_cuda.launch_counts() == {"wedge_colors": 1, "wedge_render": 1}
    for k, v in out.items():
        assert v.dtype == torch.float32 and torch.isfinite(v).all(), k


def test_shapes_synthesis_card_vs_cpu(dev):
    """The train/val scene synthesis at 147x147 from the same draws, on the
    card and on the CPU: the SDFs' cos/sin and the blurs' sums differ in
    the last bits, so a knife-edge pixel may flip. The rounded images differ
    by at most 1 on at most 1e-3 of their entries, the other maps on at
    most 1e-3 of theirs (the distances and Sobel maps, which a flipped
    boundary or rounded pixel moves around it, on at most 1e-2) by more
    than 1e-4."""
    from blurry_edges_tpu_torch.data import shapes_gen as sg

    cfg = sg.ShapeGenConfig()
    draws = sg.draw_shapes(torch.Generator().manual_seed(5), 4, cfg)
    cpu = sg.synthesize_from_draws(draws, cfg)
    card = sg.synthesize_from_draws({k: v.to(dev) for k, v in draws.items()}, cfg)
    d_img = (card["imgs"].cpu() - cpu["imgs"]).abs()
    assert d_img.max().item() <= 1 and (d_img > 0).float().mean().item() <= 1e-3
    for k, share in (("img_aif", 1e-3), ("boundary_loc", 1e-3), ("image_depth", 1e-3),
                     ("boundary_depth", 1e-3), ("boundary_dist", 1e-2), ("deri", 1e-2)):
        d = (card[k].cpu() - cpu[k]).abs()
        assert card[k].shape == cpu[k].shape and (d > 1e-4).float().mean().item() <= share, k


def test_render_layer_card_vs_cpu(dev):
    """The test sets' layered defocus at 147x147 (151 key-points x 2
    apertures x 4 channels in one depthwise convolution a pass), card
    against CPU, as tests/test_torch_realistic_gen.py holds it to JAX's:
    rtol 1e-4, atol 1e-3 on values up to 255."""
    from blurry_edges_tpu_torch.data import realistic_gen as rg

    g = torch.Generator().manual_seed(6)
    H = 147
    yy = torch.arange(H, dtype=torch.float32)[:, None].expand(H, H) / H
    depth = 0.8 + 0.3 * yy + 0.02 * torch.rand((H, H), generator=g)
    pts = rg._linspace(depth.max(), depth.min(), 151)
    img = torch.rand((H, H, 3), generator=g) * 255
    mask = torch.rand((H, H), generator=g) < 0.5
    want_img, want_mask = rg.render_layer(depth, pts, img, mask, CamConfig(), 4.0, 17)
    with float32_precision():
        got_img, got_mask = rg.render_layer(depth.to(dev), pts.to(dev), img.to(dev),
                                            mask.to(dev), CamConfig(), 4.0, 17)
    torch.testing.assert_close(got_img.cpu(), want_img, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(got_mask.cpu(), want_mask, rtol=1e-4, atol=1e-5)


def test_precal_tokens_card_vs_cpu(dev):
    """Global precal's tokens at 147x147, 2 pairs, random full-width local
    weights, card (CNN by cuDNN, colors by the wedge_colors kernel, one
    launch) against CPU (the plain colors). The colors the kernel solves
    from the card's own parameters are the plain version's to rtol 2e-3 /
    atol 2e-4. End to end two float32 CNNs differ in the last bits, which
    the colors amplify and which flip an angle's wrap at 0 / 2 pi: at most
    1% of the token entries lie outside rtol 2e-3 / atol 2e-4 (the JAX and
    port CPU chains over 36 committed-weight blocks: 0.29%)."""
    from blurry_edges_tpu_torch.ops.params import wrap_local_params
    from blurry_edges_tpu_torch.ops.patchify import unfold
    from blurry_edges_tpu_torch.train.global_precal import make_precal_fn

    mods = random_modules(torch.Generator().manual_seed(0), "cpu")
    local_cpu = mods.local_model
    local_card = random_modules(torch.Generator().manual_seed(0), dev).local_model
    g = torch.Generator().manual_seed(9)
    pairs = torch.rand((2, 2, 147, 147, 3), generator=g)
    grid = GridConfig()
    want = make_precal_fn(local_cpu, PATCH, grid)(pairs)
    wedge_cuda.reset_launch_counts()
    got = make_precal_fn(local_card, PATCH, grid)(pairs.to(dev))
    torch.cuda.synchronize()
    assert wedge_cuda.launch_counts()["wedge_colors"] == 1
    assert got.shape == want.shape == (2, 2, grid.num_tokens, 19)
    far = ((got.cpu() - want).abs() > 2e-4 + 2e-3 * want.abs()).float().mean().item()
    assert torch.isfinite(got).all() and far <= 1e-2, far
    with torch.inference_mode(), float32_precision():
        flat = unfold(pairs.to(dev).reshape(4, 147, 147, 3), R, 2).reshape(-1, R, R, 3)
        params = wrap_local_params(local_card(flat)).contiguous()
        colors = wedge_cuda.wedge_colors(params, flat, PATCH)
        plain = wedge_cuda.wedge_colors_plain(params, flat, PATCH)
    torch.testing.assert_close(colors, plain, rtol=2e-3, atol=2e-4)


def unet_step(device, sparse, target, dtype=torch.float32):
    """One densify train step with gradient matching of the trainer's fresh
    U-Net (Flax's default init from its seed) in ``dtype``: loss, clipped
    gradients, update over lr, running statistics."""
    from blurry_edges_tpu_torch.models.unet import UNet
    from blurry_edges_tpu_torch.train import densify as td
    from blurry_edges_tpu_torch.train.optim import flax_default_init, make_optimizer

    model = UNet()
    flax_default_init(model, torch.Generator().manual_seed(td.SEED))
    model.to(device=device, dtype=dtype)
    opt = make_optimizer(model.parameters(), 1e-4)
    before = [p.detach().clone() for p in model.parameters()]
    step, _ = td.make_steps(model, opt, grad_loss_w=0.5)
    loss = float(step(sparse[:, None].to(device, dtype), target.to(device, dtype)))
    grads = torch.cat([p.grad.flatten().cpu() for p in model.parameters()]).double()
    upd = torch.cat([((p.detach() - b) / 1e-4).flatten().cpu()
                     for p, b in zip(model.parameters(), before)]).double()
    stats = torch.cat([b.flatten().cpu() for n, b in model.named_buffers()
                       if n.endswith(("running_mean", "running_var"))]).double()
    return loss, grads, upd, stats


def test_unet_train_step_card_vs_cpu(dev):
    """One densify train step at 41x41, batch 2, from the same init: the
    card's float64 step is the CPU's (loss to 1e-10, gradient to 1e-8);
    the card's float32 step (cuDNN, TF32 off) against the CPU's float64:
    the loss to rtol 1e-4, the running statistics to the CPU's float32
    ones to 1e-5, and Adam's first update within 2e-3 of lr wherever the
    float64 gradient lies 10x beyond both float32 gradients' distance to
    it and at least 100 Adam eps (over half the entries)."""
    g = torch.Generator().manual_seed(21)
    target = torch.rand((2, 41, 41), generator=g) * 0.43 + 0.75
    sparse = torch.where(torch.rand(target.shape, generator=g) < 0.4, target, 0.0)
    (lc, gc, uc, sc), (lp, gp, up, sp) = unet_step(dev, sparse, target), unet_step("cpu", sparse,
                                                                                   target)
    lr, gr, ur, _ = unet_step("cpu", sparse, target, torch.float64)
    l64, g64, _, _ = unet_step(dev, sparse, target, torch.float64)
    assert abs(l64 - lr) < 1e-10 * abs(lr) and (g64 - gr).norm() < 1e-8 * gr.norm()
    assert abs(lc - lr) < 1e-4 * abs(lr)
    assert (sc - sp).abs().max().item() < 1e-5
    clear = (gr.abs() > 10 * torch.maximum((gc - gr).abs(), (gp - gr).abs())) & (gr.abs() >= 1e-6)
    d = (uc - ur).abs()
    assert clear.double().mean() > 0.5 and d[clear].max() < 2e-3 and d.max() <= 2.0


def test_world_size_1_nccl_eval(dev, tmp_path):
    """eval through its data-parallel path in one rank under NCCL (the
    CLI's mode run inside parallel.launch) gives one process's metrics,
    and its launches are the rank's."""
    from blurry_edges_tpu_torch import cli
    from blurry_edges_tpu_torch.parallel import launch

    mods = random_modules(torch.Generator().manual_seed(4), "cpu")
    torch.save(mods.local_model.state_dict(), tmp_path / "best_run_exp_local_stage.pth")
    torch.save(mods.global_model.state_dict(), tmp_path / "best_run_exp_global_stage.pth")
    rng = np.random.default_rng(2)
    data = tmp_path / "t"
    data.mkdir()
    np.save(data / "images_ny.npy", rng.integers(0, 190, (3, 2, 41, 41, 3)).astype(np.uint8))
    np.save(data / "depth_maps.npy", rng.uniform(0.75, 1.18, (3, 41, 41)).astype(np.float32))
    np.save(data / "alphas.npy", np.full(3, 190.0, np.float32))
    argv = ["--cuda", "cuda:0", "--img_size", "41", "41", "--data_path", str(data),
            "--model_path", str(tmp_path), "--log_path", str(tmp_path / "logs"), "--vis_max", "1"]
    one = cli.eval_main(argv)
    two = launch(cli.eval_main, 1, backend="nccl", devices=["cuda:0"], args=(argv,),
                 timeout=300)[0]
    for k in ("delta1", "delta2", "delta3", "rmse", "absrel"):
        assert abs(two[k] - one[k]) < 1e-6, k


# the COCO test-set source: nvJPEG's decodes against OpenCV's (the
# fixture's decoded_cv2/), bounds set from the first card run (PERF.md;
# an H100 80GB HBM3 at 700 W): at most 3 levels and 0.0183 on average
# then, the IDCT's rounding carried through the colour conversion
NVJPEG_MAX_ABS, NVJPEG_MEAN_ABS = 4, 0.05


def fixture_path():
    from pathlib import Path

    return Path(__file__).resolve().parent / "data" / "coco_fixture"


def test_nvjpeg_decodes_match_opencv(dev):
    import hashlib
    import json

    from blurry_edges_tpu_torch.data import imageio

    fix = fixture_path()
    jpegs = sorted(fix.glob("coco/val2017/*.jpg")) + sorted(fix.glob("painting/*.jpg"))
    before = imageio.launch_counts()["nvjpeg_decode"]
    for path in jpegs:
        tag = "val2017" if "val2017" in str(path) else "painting"
        want = imageio.decode_png((fix / "decoded_cv2" / f"{tag}_{path.stem}.png").read_bytes())
        got = imageio.imread(str(path), dev)
        assert got.device.type == "cuda" and got.dtype == torch.uint8
        assert tuple(got.shape) == want.shape, path
        d = np.abs(got.cpu().numpy().astype(np.int16) - want)
        assert d.max() <= NVJPEG_MAX_ABS and d.mean() <= NVJPEG_MEAN_ABS, (path, d.max(), d.mean())
    assert imageio.launch_counts()["nvjpeg_decode"] - before == len(jpegs)
    for key, (shape, digest) in json.loads((fix / "decoded_cv2" / "png_sha256.json").read_text()).items():
        folder = "coco/val2017" if key.startswith("val2017") else "painting"
        got = imageio.imread(str(fix / folder / key.split("/")[1]), dev).cpu().numpy()
        assert list(got.shape) == shape and hashlib.sha256(got.tobytes()).hexdigest() == digest


def test_coco_item_resize_and_mask_card_vs_cpu(dev):
    """One fixture item's mask and object, resized and cropped as the loader
    does, on the card and on the CPU from the same decoded image: equal bit
    for bit (integer arithmetic throughout)."""
    from blurry_edges_tpu_torch.data import realistic_gen as rg
    from blurry_edges_tpu_torch.data.coco import SimpleCOCO
    from blurry_edges_tpu_torch.ops.resize import resize_linear_u8
    from blurry_edges_tpu_torch.data import imageio

    fix = fixture_path()
    reader = SimpleCOCO(str(fix / "coco" / "instances_val2017.json"))
    ann = reader.anns[100]
    mask = torch.from_numpy(reader.annToMask(ann))
    arr = imageio.imread(str(fix / "coco" / "val2017" / reader.imgs[ann["image_id"]]["file_name"]),
                         dev)
    for size in (147, 587):
        for a in (mask, arr.cpu() * mask[..., None]):
            want = rg._scaled_crop(a, (size, size))
            got = rg._scaled_crop(a.to(dev), (size, size))
            assert got.device.type == "cuda" and torch.equal(got.cpu(), want)
    img = torch.randint(0, 256, (480, 640, 3), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(1))
    assert torch.equal(resize_linear_u8(img.to(dev), 783, 587).cpu(),
                       resize_linear_u8(img, 783, 587))


def test_image_library_is_apart_from_the_kernels(dev):
    from blurry_edges_tpu_torch.ops._build import load_image_library, load_library

    image, kernels = load_image_library(), load_library()
    assert image.path.name.startswith("libimage_") and kernels.path.name.startswith("libkernels_")
    assert image.path != kernels.path
    assert b"libnvjpeg" in image.path.read_bytes()
    assert b"libnvjpeg" not in kernels.path.read_bytes()
