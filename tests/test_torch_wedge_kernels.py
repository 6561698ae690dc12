"""The plain versions of the port's two wedge kernels against the JAX
package's TPU kernels (Pallas in interpret mode) and its plain XLA paths, on
the CPU; and the wrappers' device dispatch.

The CUDA kernels themselves only run on a card: tests/test_torch_cuda.py
holds them against these plain versions there, as chip_smoke.py does.
Tolerances are the ones tests/test_wedge_pallas.py holds the TPU kernels to:
colors rtol 2e-3 / atol 2e-4 (float32 sums in another order through a
Cayley-Hamilton determinant); render outputs p99.9 |diff| < 1e-3 * scale,
under 2e-3 of the entries off by more than 0.01 * scale, and under 1e-3 of
the integer mask flipped (knife-edge thresholds under another erf).
"""

import numpy as np
import numpy.testing as npt
import pytest
import torch

import jax.numpy as jnp

from blurry_edges_tpu.config import CamConfig as JaxCam, PatchConfig as JaxPatch
from blurry_edges_tpu.eval.pipeline import render_full as jax_render_full
from blurry_edges_tpu.ops.dfd import DfDSolver as JaxDfD
from blurry_edges_tpu.ops.params import wrap_local_params as jax_wrap
from blurry_edges_tpu.ops.wedge import params2etas as jax_params2etas
from blurry_edges_tpu.ops.wedge_pallas import wedge_colors_pallas, wedge_render_pallas
from blurry_edges_tpu.train.global_precal import solve_patch_colors as jax_solve_colors

from blurry_edges_tpu_torch.config import CamConfig, PatchConfig
from blurry_edges_tpu_torch.eval.pipeline import render_full
from blurry_edges_tpu_torch.ops import wedge_cuda
from blurry_edges_tpu_torch.ops.dfd import DfDSolver

torch.set_num_threads(1)  # torch's and XLA-CPU's thread pools share this process

rng = np.random.default_rng(12)
PATCH, JPATCH = PatchConfig(), JaxPatch()
DFD = DfDSolver.from_config(CamConfig(), PATCH)
JDFD = JaxDfD.from_config(JaxCam(), JPATCH)
DFD_CONSTS = (JDFD.numerator, JDFD.denominator_constant,
              JDFD.denominator_factor_root, JDFD.intercept, JDFD.s)
R = PATCH.R


def colors_inputs(P):
    params = rng.normal(scale=1.5, size=(P, 10)).astype(np.float32)
    pixels = rng.uniform(0, 1, size=(P, R, R, 3)).astype(np.float32)
    return params, pixels


def render_inputs(B=1, Hp=3, Wp=4):
    xy = np.concatenate([rng.uniform(-0.8, 0.8, (B, Hp, Wp, 4)),
                         rng.uniform(0, 2 * np.pi, (B, Hp, Wp, 4))], -1).astype(np.float32)
    etas = np.asarray(jax_params2etas(jnp.asarray(
        rng.normal(size=(B, Hp, Wp, 4)).astype(np.float32))))
    imgs = rng.uniform(0, 1, (B, 2, Hp, Wp, R, R, 3)).astype(np.float32)
    return xy, etas, imgs


def t(a):
    return torch.tensor(np.asarray(a))


def assert_render_close(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g, w = got[k].numpy(), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if k == "depth_mask":
            assert np.mean(g != w) < 1e-3, (k, np.mean(g != w))
            continue
        d = np.abs(g - w)
        scale = max(1.0, np.abs(w).max())
        assert np.quantile(d, 0.999) < 1e-3 * scale, (k, np.quantile(d, 0.999))
        assert np.mean(d > 0.01 * scale) < 2e-3, (k, np.mean(d > 0.01 * scale))


# ---------------------------------------------------------------- colors


def test_plain_colors_match_pallas_kernel():
    params, pixels = colors_inputs(40)
    want = wedge_colors_pallas(jnp.asarray(params), jnp.asarray(pixels), R=R,
                               w=JPATCH.w, lambda_ridge=JPATCH.lambda_ridge,
                               interpret=True)
    got = wedge_cuda.wedge_colors_plain(t(params), t(pixels), PATCH)
    npt.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3, atol=2e-4)


def test_solve_patch_colors_matches_jax_flat_path():
    # the JAX package's solve over leading axes (2, 32), the port's
    # wedge_colors over the same 64 patches given flat
    params, pixels = colors_inputs(64)
    wrapped = np.asarray(jax_wrap(jnp.asarray(params)))
    want = jax_solve_colors(jnp.asarray(wrapped.reshape(2, 32, 10)),
                            jnp.asarray(pixels.reshape(2, 32, R, R, 3)), JPATCH)
    got = wedge_cuda.wedge_colors(t(wrapped), t(pixels), PATCH)
    assert got.shape == (64, 3, 3)
    npt.assert_allclose(got.numpy(), np.asarray(want).reshape(64, 3, 3),
                        rtol=2e-3, atol=2e-4)


def test_plain_colors_degenerate_params():
    # identical corners, zero opening: the ridge keeps everything finite
    params = np.zeros((8, 10), np.float32)
    params[:, 8:] = 2.0
    pixels = rng.uniform(0, 1, size=(8, R, R, 3)).astype(np.float32)
    got = wedge_cuda.wedge_colors_plain(t(params), t(pixels), PATCH)
    want = wedge_colors_pallas(jnp.asarray(params), jnp.asarray(pixels), interpret=True)
    assert torch.isfinite(got).all()
    npt.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3, atol=2e-4)


# ---------------------------------------------------------------- render


@pytest.mark.parametrize("hard", [False, True])
def test_plain_render_matches_jax_render_full(hard):
    xy, etas, imgs = render_inputs(B=2)
    want = jax_render_full(jnp.asarray(xy), jnp.asarray(etas), jnp.asarray(imgs),
                           JPATCH, JDFD, 10.39, hard)
    got = render_full(t(xy), t(etas), t(imgs), PATCH, DFD, 10.39, hard)
    assert_render_close(got, want)


@pytest.mark.parametrize("hard", [False, True])
def test_plain_render_matches_pallas_kernel(hard):
    xy, etas, imgs = render_inputs()
    P = xy.shape[1] * xy.shape[2]
    out = wedge_render_pallas(
        jnp.asarray(xy.reshape(P, 8)), jnp.asarray(etas.reshape(P, 4)),
        jnp.asarray(np.moveaxis(imgs, 1, 3).reshape(P, 2, R, R, 3)), R=R,
        w=JPATCH.w, lambda_ridge=JPATCH.lambda_ridge, hard=hard,
        rho_prime=10.39, dfd_consts=DFD_CONSTS, interpret=True)
    want = {k: np.asarray(v)[None].reshape((1, 3, 4) + v.shape[1:])
            for k, v in out.items()}
    want["patches"] = np.moveaxis(want["patches"], 3, 1)   # (1, 2, Hp, Wp, R, R, 3)
    got = wedge_cuda.wedge_render_plain(t(xy), t(etas), t(imgs), PATCH, DFD, 10.39, hard)
    assert_render_close(got, want)


@pytest.mark.parametrize("hard", [False, True])
def test_plain_render_degenerate(hard):
    """All-zero corners and angles stay finite through the joint solve, the
    DfD projection and the refocus blur, and agree with the TPU kernel."""
    P = 8
    imgs = rng.uniform(0, 1, (1, 2, 2, 4, R, R, 3)).astype(np.float32)
    got = wedge_cuda.wedge_render_plain(
        torch.zeros((1, 2, 4, 8)), torch.full((1, 2, 4, 4), 0.01), t(imgs),
        PATCH, DFD, 10.39, hard)
    for k, v in got.items():
        assert torch.isfinite(v.float()).all(), k
    out = wedge_render_pallas(
        jnp.zeros((P, 8)), jnp.full((P, 4), 0.01),
        jnp.asarray(np.moveaxis(imgs, 1, 3).reshape(P, 2, R, R, 3)), R=R,
        w=JPATCH.w, lambda_ridge=JPATCH.lambda_ridge, hard=hard,
        dfd_consts=DFD_CONSTS, interpret=True)
    want = {k: np.asarray(v).reshape((1, 2, 4) + v.shape[1:]) for k, v in out.items()}
    want["patches"] = np.moveaxis(want["patches"], 3, 1)
    assert_render_close(got, want)


# ---------------------------------------------------------------- dispatch


def test_wrappers_run_plain_on_cpu_tensors_only():
    """A CPU tensor takes the plain version (no launch is counted); a tensor
    on any other non-CUDA device, or on mixed devices, raises."""
    params, pixels = colors_inputs(6)
    xy, etas, imgs = render_inputs()
    wedge_cuda.reset_launch_counts()
    got = wedge_cuda.wedge_colors(t(params), t(pixels), PATCH)
    npt.assert_array_equal(got.numpy(),
                           wedge_cuda.wedge_colors_plain(t(params), t(pixels), PATCH).numpy())
    rend = wedge_cuda.wedge_render(t(xy), t(etas), t(imgs), PATCH, DFD, 10.39, False)
    plain = wedge_cuda.wedge_render_plain(t(xy), t(etas), t(imgs), PATCH, DFD, 10.39, False)
    for k in plain:
        npt.assert_array_equal(rend[k].numpy(), plain[k].numpy())
    assert wedge_cuda.launch_counts() == {"wedge_colors": 0, "wedge_render": 0}

    meta = torch.empty((6, 10), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        wedge_cuda.wedge_colors(meta, torch.empty((6, R, R, 3), device="meta"), PATCH)
    with pytest.raises(ValueError, match="several devices"):
        wedge_cuda.wedge_colors(t(params), torch.empty((6, R, R, 3), device="meta"), PATCH)
    with pytest.raises(ValueError, match="unsupported device"):
        wedge_cuda.wedge_render(t(xy).to("meta"), t(etas).to("meta"), t(imgs).to("meta"),
                                PATCH, DFD, 10.39, False)
