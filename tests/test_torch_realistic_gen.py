"""The port's realistic test-set generator (``data/realistic_gen.py``)
against the JAX package's procedural source.

- ``cubic_resize`` (the textures' upsampling) against ``jax.image.resize(...,
  "bicubic")`` to 1e-5, up and down;
- ``render_layer`` at 40x40 to rtol 1e-4 (atol 1e-3 on values up to 255: the
  151 blurs are summed in another order);
- a whole sample from JAX's own draws (the test reproduces
  ``synth_sample``'s draws from its key): the depth map to 1e-5, the image
  to rtol 1e-4 / atol 1e-2 from the same depth key points, and within the
  bound that one ulp of a key point sets without them (see the test);
- the generator's files (names, shapes, float32, integer noisy counts in
  [0, round(alpha)]: clipped to alpha, then rounded), and ``--coco`` raising
  ``FileNotFoundError`` naming the annotations file when MS-COCO is absent
  (the source itself: tests/test_torch_coco.py).
"""

import math

import numpy as np
import numpy.testing as npt
import pytest
import torch

import jax
import jax.numpy as jnp

from blurry_edges_tpu.config import CamConfig as JaxCam
from blurry_edges_tpu.data import realistic_gen as jrg

from blurry_edges_tpu_torch.config import CamConfig, get_args
from blurry_edges_tpu_torch.data import realistic_gen as rg

torch.set_num_threads(1)  # torch's and XLA-CPU's thread pools share this process

rng = np.random.default_rng(31)
K, N = 17, 40


@pytest.mark.parametrize("res", [6, 16, 48])
def test_cubic_resize_matches_jax(res):
    low = rng.random((res, res, 3)).astype(np.float32)
    for H, W in ((N, N), (147, 147), (37, 53)):
        ours = rg.cubic_resize(torch.from_numpy(low), H, W).numpy()
        theirs = np.asarray(jax.image.resize(jnp.asarray(low), (H, W, 3), method="bicubic"))
        npt.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-5)


def test_render_layer_matches_jax():
    yy = np.mgrid[0:N, 0:N][0].astype(np.float32) / N
    depth = (0.8 + 0.3 * yy + 0.02 * rng.random((N, N))).astype(np.float32)
    pts = np.linspace(depth.max(), depth.min(), 151).astype(np.float32)
    img = (rng.random((N, N, 3)) * 255).astype(np.float32)
    mask = rng.random((N, N)) < 0.5
    with jax.default_matmul_precision("highest"):
        j_img, j_mask = jrg.render_layer(jnp.asarray(depth), jnp.asarray(pts), jnp.asarray(img),
                                         jnp.asarray(mask), JaxCam(), 4.0, K)
    p_img, p_mask = rg.render_layer(torch.from_numpy(depth), torch.from_numpy(pts),
                                    torch.from_numpy(img), torch.from_numpy(mask),
                                    CamConfig(), 4.0, K)
    npt.assert_allclose(p_img.numpy(), np.asarray(j_img), rtol=1e-4, atol=1e-3)
    npt.assert_allclose(p_mask.numpy(), np.asarray(j_mask), rtol=1e-4, atol=1e-5)


def jax_sample_draws(key):
    """synth_sample's draws, line for line (realistic_gen.py:137-191)."""
    k_mask, k_fg, k_bk, k_depth = jax.random.split(key, 4)
    k1, k2, k3 = jax.random.split(k_mask, 3)
    lows = lambda k: [jax.random.uniform(kk, (r, r, 3))                   # noqa: E731
                      for kk, (r, _) in zip(jax.random.split(k, 3), rg.TEXTURE_OCTAVES)]
    d1, d2 = jax.random.split(k_depth)
    draws = dict(c=jax.random.uniform(k1, (2,), minval=0.35, maxval=0.65),
                 ab=jax.random.uniform(k2, (2,), minval=0.22, maxval=0.42),
                 th=jax.random.uniform(k3, ()) * math.pi,
                 fg_lows=lows(k_fg), bk_lows=lows(k_bk),
                 rel=jnp.sort(jax.random.uniform(d1, (4,)))[::-1],
                 angles=jax.random.uniform(d2, (2,)) * 2 * math.pi)
    return {k: [torch.from_numpy(np.array(t)) for t in v] if isinstance(v, list)
            else torch.from_numpy(np.array(v)) for k, v in draws.items()}


def jnp_linspace(start, stop, num):
    return torch.from_numpy(np.array(jnp.linspace(jnp.float32(start.item()),
                                                  jnp.float32(stop.item()), num)))


def test_sample_from_jax_draws(monkeypatch):
    """From the same key points the port's sample is JAX's to rtol 1e-4; its
    own key points are jnp.linspace's to 1 ulp. The weights divide by the
    key points' spacing (a layer's depth range / 150, 1.3e-4 m for this
    sample's foreground), so one ulp of a key point moves a pixel of up to
    255 by up to ~255 x 2 ulp / spacing: the whole sample is held to twice
    that bound."""
    key = jax.random.PRNGKey(4)
    draws = jax_sample_draws(key)
    with jax.default_matmul_precision("highest"):
        j_img, j_depth = jrg.synth_sample(key, N, N, 0.75, 1.18, JaxCam(), 4.0, K)
    j_img = np.asarray(j_img)
    p_img, p_depth = rg.synth_from_draws(draws, N, N, 0.75, 1.18, CamConfig(), 4.0, K)
    npt.assert_allclose(p_depth.numpy(), np.asarray(j_depth), rtol=1e-5, atol=1e-5)

    d_bk, d_fg, _, _ = rg.planar_depths(draws["rel"], draws["angles"], N, N, 0.75, 1.18)
    fg = d_fg[rg.ellipse_mask(draws["c"], draws["ab"], draws["th"], N, N)]
    for lo, hi in ((d_bk.min(), d_bk.max()), (fg.min(), fg.max())):
        npt.assert_allclose(rg._linspace(hi, lo, 151).numpy(), jnp_linspace(hi, lo, 151).numpy(),
                            rtol=0, atol=np.spacing(np.float32(hi.item())))
    spacing = min(float(d_bk.max() - d_bk.min()), float(fg.max() - fg.min())) / 150
    bound = 255 * 4 * np.spacing(np.float32(1.18)) / spacing
    assert np.abs(p_img.numpy() - j_img).max() < bound

    monkeypatch.setattr(rg, "_linspace", jnp_linspace)
    p_img, _ = rg.synth_from_draws(draws, N, N, 0.75, 1.18, CamConfig(), 4.0, K)
    npt.assert_allclose(p_img.numpy(), j_img, rtol=1e-4, atol=1e-2)


def test_generator_files_and_coco(tmp_path):
    args = get_args("data_gen_test", argv=["--data_path", str(tmp_path / "t"),
                                           "--img_size", "33", "33", "--num_sample_test", "2"])
    rg.SyntheticRealisticDataGenerator(args, device="cpu").generate_synthetic_data()
    out = {k: np.load(tmp_path / "t" / f"{k}.npy")
           for k in ("images_gt", "images_ny", "depth_maps", "alphas")}
    assert {k: v.shape for k, v in out.items()} == {
        "images_gt": (2, 2, 33, 33, 3), "images_ny": (2, 2, 33, 33, 3),
        "depth_maps": (2, 33, 33), "alphas": (2,)}
    assert all(v.dtype == np.float32 for v in out.values())
    a = out["alphas"][:, None, None, None, None]
    assert ((out["alphas"] >= 180) & (out["alphas"] < 200)).all()
    ny = out["images_ny"]
    assert (ny == np.round(ny)).all() and ny.min() >= 0 and (ny <= np.round(a)).all()
    assert (out["images_gt"] >= 0).all() and (out["images_gt"] <= a + 1e-3).all()
    assert ((out["depth_maps"] >= 0.75) & (out["depth_maps"] <= 1.18 + 1e-6)).all()
    with pytest.raises(FileNotFoundError, match="instances_val2017.json"):
        rg.SyntheticRealisticDataGenerator(args, source="coco", device="cpu")
