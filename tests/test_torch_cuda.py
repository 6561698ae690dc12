"""The port's CUDA kernels against their plain versions, on a CUDA card.

Every test here needs a CUDA device and skips without one. On a machine
with a card, from the repository root (tests/conftest.py imports JAX, which
that machine need not have, hence --noconftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances as chip_smoke.py states them: colors rtol 2e-3 / atol 2e-4;
render p99.9 |diff| < 1e-3 * scale, under 2e-3 of the entries off by more
than 0.01 * scale, under 1e-3 of the mask flipped.
"""

import numpy as np
import pytest
import torch

from blurry_edges_tpu_torch.config import CamConfig, GridConfig, PatchConfig
from blurry_edges_tpu_torch.eval.pipeline import make_depth_estimator
from blurry_edges_tpu_torch.ops import wedge_cuda
from blurry_edges_tpu_torch.ops.dfd import DfDSolver
from blurry_edges_tpu_torch.ops.wedge import params2etas
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
