"""The port's analytic ops (blurry_edges_tpu_torch.ops) against the JAX
package's, on the same numpy inputs, on the CPU.

Both sides evaluate the same float32 formulas; they differ only in the
library implementations of sin/cos/erf/sqrt and in summation order, so
elementwise maps are held to rtol 1e-5 / atol 1e-5 unless a case says
otherwise. The property cases mirror tests/test_wedge.py, tests/test_dfd.py
and tests/test_patchify.py.
"""

import numpy as np
import numpy.testing as npt
import pytest
import torch

import jax
import jax.numpy as jnp

from blurry_edges_tpu.config import CamConfig as JaxCam, PatchConfig as JaxPatch
from blurry_edges_tpu.ops import dfd as jdfd
from blurry_edges_tpu.ops import params as jparams
from blurry_edges_tpu.ops import patchify as jpatch
from blurry_edges_tpu.ops import wedge as jw

from blurry_edges_tpu_torch.config import CamConfig, PatchConfig
from blurry_edges_tpu_torch.ops import dfd, params, patchify, wedge

torch.set_num_threads(1)  # torch's and XLA-CPU's thread pools share this process

R = 21
LAMBDA = (5e-3 * R**2) ** 2
rng = np.random.default_rng(0)
X, Y = wedge.make_patch_grid(R)
JX, JY = jw.make_patch_grid(R)


def rand_params(*lead):
    """Random plausible patch parameters (..., 10), as tests/test_wedge.py."""
    xy = rng.uniform(-1.5, 1.5, size=lead + (4,))
    angles = rng.uniform(0, 2 * np.pi, size=lead + (4,))
    etac = rng.uniform(-1.0, 1.5, size=lead + (2,))
    return np.concatenate([xy, angles, etac], axis=-1).astype(np.float32)


def t(a):
    return torch.tensor(np.asarray(a))


def close(ours, theirs, rtol=1e-5, atol=1e-5):
    npt.assert_allclose(np.asarray(ours), np.asarray(theirs), rtol=rtol, atol=atol)


# ---------------------------------------------------------------- wedge


def test_patch_grid_matches_jax():
    close(X, JX, 0, 1e-7)
    close(Y, JY, 0, 1e-7)


def test_params2dists_matches_jax():
    p = rand_params(32)[:, :8]
    close(wedge.params2dists(t(p), X, Y), jw.params2dists(jnp.asarray(p), JX, JY))


def test_params2dists_flat_matches_gridded():
    p = rand_params(16)[:, :8]
    d1, d2 = wedge.params2dists_flat(t(p), X.reshape(-1), Y.reshape(-1))
    grid = wedge.params2dists(t(p), X, Y)
    close(d1, grid[:, 0].reshape(16, -1), 0, 0)
    close(d2, grid[:, 1].reshape(16, -1), 0, 0)


def test_params2etas_matches_jax():
    c = np.linspace(-5, 5, 101).astype(np.float32)
    etas = wedge.params2etas(t(c))
    close(etas, jw.params2etas(jnp.asarray(c)), rtol=1e-5, atol=1e-9)
    assert etas.min() >= 10**-4 - 1e-9 and etas.max() <= 1.0 + 1e-6


def test_indicators_match_jax_and_partition_unity():
    p = rand_params(64)
    dists = wedge.params2dists(t(p[:, :8]), X, Y)
    u = wedge.dists2indicators(dists, wedge.params2etas(t(p[:, 8:])))
    jd = jw.params2dists(jnp.asarray(p[:, :8]), JX, JY)
    close(u, jw.dists2indicators(jd, jw.params2etas(jnp.asarray(p[:, 8:]))),
          rtol=1e-4, atol=1e-5)
    close(u.sum(dim=-3), np.ones((64, R, R)), 0, 1e-5)
    assert (u > -1e-6).all()


def test_indicator_flat_matches_jax():
    d = rng.normal(scale=0.5, size=(8, R * R)).astype(np.float32)
    eta = rng.uniform(1e-3, 1.0, size=(8,)).astype(np.float32)
    close(wedge.indicator_flat(t(d), t(eta)),
          jw.indicator_flat(jnp.asarray(d), jnp.asarray(eta)), rtol=1e-4, atol=1e-6)


def test_boundary_map_matches_jax():
    p = rand_params(16)[:, :8]
    ours = wedge.boundary_map(wedge.params2dists(t(p), X, Y))
    close(ours, jw.boundary_map(jw.params2dists(jnp.asarray(p), JX, JY)))


@pytest.mark.parametrize("hard", [False, True])
def test_depth_masks_match_jax(hard):
    p = rand_params(32)[:, :8]
    ours = wedge.depth_masks(wedge.params2dists(t(p), X, Y), hard=hard)
    theirs = np.asarray(jw.depth_masks(jw.params2dists(jnp.asarray(p), JX, JY), hard=hard))
    assert ours.dtype == torch.int32
    # an integer threshold of float fields: a knife-edge pixel may flip
    assert np.mean(ours.numpy() != theirs) < 1e-3


def test_inverse_3x3_vs_linalg():
    M = rng.normal(size=(128, 3, 3)).astype(np.float32)
    M = M @ np.swapaxes(M, -1, -2) + 3 * np.eye(3, dtype=np.float32)
    # Cayley-Hamilton in float32: the determinant's cancellation costs digits
    close(wedge.inverse_3x3(t(M)), np.linalg.inv(M), rtol=2e-3, atol=2e-4)


def test_half_plane_wedge():
    # corner far left, theta=0, phi=pi/2: the edge theta=0 through y=0 decides
    p = torch.tensor([[-3.0, 0.0, -3.0, 0.0, 0.0, np.pi / 2, 0.0, np.pi / 2]])
    dists = wedge.params2dists(p, X, Y).numpy()
    assert (dists[0, 0, Y.numpy() > 0.05] > 0).all()
    assert (dists[0, 0, Y.numpy() < -0.05] < 0).all()


def test_ridge_solve_recovers_colors_and_matches_jax():
    p = rand_params(32)
    p[:, 8:] = -2.0  # eta ~ 1e-4: crisp wedges
    u = wedge.dists2indicators(wedge.params2dists(t(p[:, :8]), X, Y),
                               wedge.params2etas(t(p[:, 8:])))
    true_colors = t(rng.uniform(0.2, 0.8, size=(32, 3, 3)).astype(np.float32))
    patch = wedge.render_patches(u, true_colors)
    A = torch.movedim(u, -3, -1).reshape(32, R * R, 3)
    yv = patch.reshape(32, R * R, 3)
    colors = wedge.solve_colors(A, yv, LAMBDA)
    An, yn = A.numpy().astype(np.float64), yv.numpy().astype(np.float64)
    expected = np.linalg.solve(An.transpose(0, 2, 1) @ An + LAMBDA * np.eye(3),
                               An.transpose(0, 2, 1) @ yn)
    close(colors, expected, rtol=5e-3, atol=5e-3)
    # same solve in JAX: float32 sums in another order through the same
    # Cayley-Hamilton inverse
    close(colors, jw.solve_colors(jnp.asarray(A.numpy()), jnp.asarray(yv.numpy()), LAMBDA),
          rtol=2e-3, atol=2e-4)
    close(patch, jw.render_patches(jnp.asarray(u.numpy()), jnp.asarray(true_colors.numpy())))


# ---------------------------------------------------------------- params


def test_param_transforms_match_jax():
    raw = rng.normal(scale=4.0, size=(2, 7, 10)).astype(np.float32)
    colors = rng.uniform(0, 1, size=(2, 7, 3, 3)).astype(np.float32)
    est = rng.normal(size=(2, 7, 12)).astype(np.float32)
    wrapped = params.wrap_local_params(t(raw))
    close(wrapped, jparams.wrap_local_params(jnp.asarray(raw)))
    close(params.normalize_token_features(wrapped, t(colors)),
          jparams.normalize_token_features(jnp.asarray(wrapped.numpy()), jnp.asarray(colors)))
    close(params.denormalize_global_eval(t(est)),
          jparams.denormalize_global_eval(jnp.asarray(est)))


# ---------------------------------------------------------------- dfd

SOLVER = dfd.DfDSolver.from_config(CamConfig(), PatchConfig())
JSOLVER = jdfd.DfDSolver.from_config(JaxCam(), JaxPatch())


def test_dfd_constants_match_jax():
    for f in ("numerator", "denominator_constant", "denominator_factor_root",
              "intercept", "s"):
        assert getattr(SOLVER, f) == getattr(JSOLVER, f), f


def test_dfd_roundtrip_on_curve():
    z = torch.linspace(0.76, 1.17, 64)
    cam = CamConfig()
    z_rec = SOLVER.etas2depth(SOLVER.depth2sigma(z, cam.rho_1),
                              SOLVER.depth2sigma(z, cam.rho_2))
    close(z_rec, z, rtol=1e-3, atol=0)


def test_dfd_matches_jax():
    e1 = rng.uniform(1e-4, 1.0, size=(512,)).astype(np.float32)
    e2 = rng.uniform(1e-4, 1.0, size=(512,)).astype(np.float32)
    close(SOLVER.etas2depth(t(e1), t(e2)),
          JSOLVER.etas2depth(jnp.asarray(e1), jnp.asarray(e2)), rtol=1e-4, atol=1e-5)
    z = rng.uniform(0.75, 1.18, size=(512,)).astype(np.float32)
    close(SOLVER.depth2sigma(t(z), 10.39), JSOLVER.depth2sigma(jnp.asarray(z), 10.39),
          rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------- patchify


def test_unfold_matches_slicing_and_jax():
    img = rng.normal(size=(2, 49, 49, 3)).astype(np.float32)
    out = patchify.unfold(t(img), R, 2).numpy()
    Hp = (49 - R) // 2 + 1
    assert out.shape == (2, Hp, Hp, R, R, 3)
    for i in (0, 5, Hp - 1):
        for j in (0, 7, Hp - 1):
            npt.assert_array_equal(out[:, i, j], img[:, 2 * i:2 * i + R, 2 * j:2 * j + R])
    npt.assert_array_equal(out, np.asarray(jpatch.unfold(jnp.asarray(img), R, 2)))


def test_fold_matches_jax_and_inverts_unfold():
    patches = rng.normal(size=(2, 15, 15, R, R, 3)).astype(np.float32)
    close(patchify.fold(t(patches), 49, 49, 2),
          jpatch.fold(jnp.asarray(patches), 49, 49, 2))
    img = rng.normal(size=(2, 49, 49, 3)).astype(np.float32)
    folded = patchify.fold(patchify.unfold(t(img), R, 2), 49, 49, 2)
    count = patchify.fold_count(49, 49, R, 2)
    close(folded / count[None, :, :, None], img)


def test_fold_count_147():
    count = patchify.fold_count(147, 147, 21, 2).numpy()
    assert count.shape == (147, 147)
    assert count.max() == 121.0 and count.min() == 1.0
    npt.assert_array_equal(count, np.asarray(jpatch.fold_count(147, 147, 21, 2)))


def test_jax_stays_on_cpu():
    # the comparisons above are CPU against CPU
    assert all(d.platform == "cpu" for d in jax.devices())
