"""The port's depth-completion U-Net against the JAX package's Flax UNet.

- Forward parity: random Flax weights (BatchNorm statistics, scales and
  biases perturbed, so that every mapped tensor matters; the test checks
  that the output is not a constant, as it is where every ReLU is off)
  bridged by ``jax_unet_to_torch``, eval mode, at 41x41 and 147x147: both
  odd, so the floor pooling and the (0, 1) center padding of the
  upsampled maps run.
  Both sides are float32 on the CPU, the JAX side at HIGHEST matmul
  precision; the convolutions sum in another order, so rtol 1e-4 and atol
  1e-4 x max|out|.
- Keys: the bridge gives exactly the module's state-dict keys, and a state
  dict under the reference's keys (the ones the JAX package's torch -> Flax
  converter reads, plus each BatchNorm's ``num_batches_tracked``) loads
  strictly, and round-trips through that converter and the bridge bit for
  bit.
"""

import numpy as np
import numpy.testing as npt
import pytest
import torch

import jax
import jax.numpy as jnp

from blurry_edges_tpu import models as jmodels
from blurry_edges_tpu.utils import torch_convert as tc

from blurry_edges_tpu_torch.models.unet import UNet
from blurry_edges_tpu_torch.models.weights import jax_unet_to_torch

torch.set_num_threads(1)  # torch's and XLA-CPU's thread pools share this process

rng = np.random.default_rng(11)


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def perturbed_unet_vars(seed=0):
    """Flax UNet variables from its own init, with the batch means drawn
    from U(-0.1, 0.1), the variances from U(0.5, 1.5), and U(-0.1, 0.1)
    added to every scale and bias (zero or one at init). (Means as large
    as the variances' draws, as the pipeline tests give the LocalStage,
    turn every ReLU off here: a constant output.)"""
    v = to_numpy(jmodels.UNet().init(jax.random.PRNGKey(seed), jnp.zeros((1, 41, 41, 1))))
    v["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda path, a: rng.uniform(*((-0.1, 0.1) if path[-1].key == "mean" else (0.5, 1.5)),
                                    a.shape).astype(np.float32), v["batch_stats"])
    v["params"] = jax.tree.map(
        lambda a: (a + rng.uniform(-0.1, 0.1, a.shape)).astype(np.float32) if a.ndim == 1 else a,
        v["params"])
    return v


def bridged_unet(v) -> UNet:
    model = UNet()
    model.load_state_dict(jax_unet_to_torch(v["params"], v["batch_stats"]))
    return model.eval()


def sparse_depth(B, H):
    """Depth maps as the pp densify gets them: metric depths where a wedge
    owned the pixel, zeros elsewhere."""
    d = rng.uniform(0.75, 1.18, size=(B, H, H)).astype(np.float32)
    return np.where(rng.uniform(size=d.shape) < 0.5, d, 0.0).astype(np.float32)


@pytest.fixture(scope="module")
def unet_vars():
    return perturbed_unet_vars()


@pytest.mark.parametrize("H", [41, 147])
def test_unet_matches_flax(unet_vars, H):
    x = sparse_depth(2, H)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jmodels.UNet().apply(unet_vars, jnp.asarray(x[..., None]),
                                               train=False))[..., 0]
    with torch.no_grad():
        got = bridged_unet(unet_vars)(torch.from_numpy(x)[:, None])[:, 0].numpy()
    assert got.shape == (2, H, H)
    assert want.std() > 1e-2 * np.abs(want).max()   # not a constant map
    npt.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_bridge_keys_are_the_modules(unet_vars):
    sd = jax_unet_to_torch(unet_vars["params"], unet_vars["batch_stats"])
    assert set(sd) == set(UNet().state_dict())
    assert 30e6 < sum(p.numel() for p in UNet().parameters()) < 32e6   # ~31 M


class _Recording(dict):
    """A dict that records the keys read from it."""

    def __init__(self, *a):
        super().__init__(*a)
        self.read = set()

    def __getitem__(self, k):
        self.read.add(k)
        return super().__getitem__(k)

    def __contains__(self, k):   # a present key tested for is read next
        present = super().__contains__(k)
        if present:
            self.read.add(k)
        return present


def test_reference_state_dict_loads():
    torch.manual_seed(0)
    source = UNet()
    for m in source.modules():   # non-trivial statistics
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.uniform_(-0.5, 0.5)
            m.running_var.uniform_(0.5, 1.5)
    sd = {k: v.numpy() for k, v in source.state_dict().items()}
    recording = _Recording(sd)
    params, stats = tc.convert_unet(recording)
    reference_keys = recording.read | {k for k in sd if k.endswith("num_batches_tracked")}
    # the reference's keys are exactly the module's
    assert reference_keys == set(sd)
    target = UNet()
    result = target.load_state_dict({k: torch.from_numpy(sd[k]) for k in reference_keys})
    assert not result.missing_keys and not result.unexpected_keys
    # the JAX package's converter and the bridge are inverses
    back = jax_unet_to_torch(params, stats)
    for k, v in source.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(back[k], v), k
