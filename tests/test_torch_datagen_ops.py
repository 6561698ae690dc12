"""The port's optics and morphology (``ops/optics.py``, ``ops/morphology.py``)
against the JAX package's, on the same numpy inputs.

- ``kernel_sigma``, ``max_kernel_halfwidth``, the PSF bank and
  ``blur_fixed_support`` to rtol 1e-5 (float32 on both sides, the JAX
  convolutions at HIGHEST precision);
- the dilations and ``distance_transform_l1`` exactly, on random masks and
  an empty one; the port's transform also equals its BFS oracle.
"""

import numpy as np
import numpy.testing as npt
import pytest
import torch

import jax
import jax.numpy as jnp

from blurry_edges_tpu.config import CamConfig as JaxCam
from blurry_edges_tpu.ops import morphology as jmorph
from blurry_edges_tpu.ops import optics as joptics

from blurry_edges_tpu_torch.config import CamConfig
from blurry_edges_tpu_torch.ops import morphology, optics

torch.set_num_threads(1)  # torch's and XLA-CPU's thread pools share this process

rng = np.random.default_rng(23)
K = optics.max_kernel_halfwidth(CamConfig(), 4.0, (0.75, 1.18))


def test_kernel_sigma_and_halfwidth():
    z = rng.uniform(0.75, 1.18, (5, 7)).astype(np.float32)
    npt.assert_allclose(optics.kernel_sigma(torch.from_numpy(z), CamConfig(), 4.0).numpy(),
                        np.asarray(joptics.kernel_sigma(jnp.asarray(z), JaxCam(), 4.0)),
                        rtol=1e-6)
    assert K == joptics.max_kernel_halfwidth(JaxCam(), 4.0, (0.75, 1.18)) == 17


def test_psf_bank_and_blur_match_jax():
    sig = np.concatenate([rng.uniform(0.05, 5.6, 6), [1e-9, 2.0 / 3.0]]).astype(np.float32)
    npt.assert_allclose(optics.gaussian_psf_bank(torch.from_numpy(sig), K).numpy(),
                        np.asarray(joptics.gaussian_psf_bank(jnp.asarray(sig), K)),
                        rtol=1e-5, atol=1e-7)
    imgs = (rng.random((len(sig), 29, 33)) * 255).astype(np.float32)
    ours = optics.blur_fixed_support(torch.from_numpy(imgs), torch.from_numpy(sig), K).numpy()
    with jax.default_matmul_precision("highest"):
        theirs = np.stack([np.asarray(joptics.blur_fixed_support(jnp.asarray(im), s, K))
                           for im, s in zip(imgs, sig)])
    npt.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-3)    # atol: 255 x 4e-6


def test_symmetric_pad_is_numpys():
    x = rng.random((2, 5, 19, 23)).astype(np.float32)
    npt.assert_array_equal(optics.symmetric_pad(torch.from_numpy(x), 17).numpy(),
                           np.pad(x, ((0, 0), (0, 0), (17, 17), (17, 17)), mode="symmetric"))


@pytest.mark.parametrize("density", [0.0, 0.003, 0.05, 0.3])
def test_morphology_matches_jax(density):
    masks = rng.random((3, 31, 26)) < density
    t = torch.from_numpy(masks)
    npt.assert_array_equal(morphology.dilate_cross(t).numpy(),
                           np.asarray(jmorph.dilate_cross(jnp.asarray(masks))))
    npt.assert_array_equal(morphology.dilate_full(t).numpy(),
                           np.asarray(jmorph.dilate_full(jnp.asarray(masks))))
    for n in (1, 11):
        npt.assert_array_equal(morphology.dilate_full_n(t, n).numpy(),
                               np.asarray(jmorph.dilate_full_n(jnp.asarray(masks), n)))
    ours = morphology.distance_transform_l1(t).numpy()
    for i, m in enumerate(masks):
        npt.assert_array_equal(ours[i], np.asarray(jmorph.distance_transform_l1(jnp.asarray(m))))
        npt.assert_array_equal(ours[i], morphology.distance_transform_l1_bfs(t[i], 200).numpy())
    if density == 0.0:
        assert (ours == 1.0).all()
