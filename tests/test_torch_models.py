"""The port's models and weight bridge against the JAX package's Flax models.

- The bridge (blurry_edges_tpu_torch.utils.weights) inverts the JAX
  package's torch -> Flax converter exactly: a round trip gives the Flax
  tree back bit for bit.
- With the committed checkpoints, bridged into the port, the eval-mode
  forwards agree with Flax ``apply`` (64 patches through the local stage,
  64 tokens through all 8 global layers). Both run float32 on the CPU, the
  JAX side at HIGHEST matmul precision; convolutions and matmuls sum in
  another order, so rtol 1e-4 / atol 1e-5.
"""

import os

import numpy as np
import numpy.testing as npt
import pytest
import torch

import jax
import jax.numpy as jnp

from blurry_edges_tpu import models as jmodels
from blurry_edges_tpu.train.checkpoint import load_checkpoint
from blurry_edges_tpu.utils import torch_convert as tc

from blurry_edges_tpu_torch.models.global_stage import GlobalStage
from blurry_edges_tpu_torch.models.local_stage import LocalStage
from blurry_edges_tpu_torch.utils.weights import (jax_global_to_torch,
                                                  jax_local_to_torch,
                                                  random_modules)

torch.set_num_threads(1)  # torch's and XLA-CPU's thread pools share this process

rng = np.random.default_rng(4)
WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "pretrained_weights")


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def sd_numpy(sd):
    return {k: v.numpy() for k, v in sd.items()}


def assert_trees_equal(a, b):
    la, ta = jax.tree.flatten(a)
    lb, tb = jax.tree.flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        npt.assert_array_equal(np.asarray(x), np.asarray(y))


def perturbed_local_vars(key):
    """Flax LocalStage variables with non-trivial BatchNorm statistics."""
    v = to_numpy(jmodels.LocalStage().init(key, jnp.zeros((1, 21, 21, 3))))
    v["batch_stats"] = jax.tree.map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), v["batch_stats"])
    return v


def test_port_models_full_width():
    g = torch.Generator().manual_seed(0)
    mods = random_modules(g, device="cpu")
    n_local = sum(p.numel() for p in mods.local_model.parameters())
    n_global = sum(p.numel() for p in mods.global_model.parameters())
    assert 6e6 < n_local < 9e6        # ~7.2 M
    assert 0.8e6 < n_global < 1.5e6   # ~1.1 M
    with torch.no_grad():
        assert mods.local_model(torch.zeros(2, 21, 21, 3)).shape == (2, 10)
        assert mods.global_model(torch.zeros(1, 64, 38)).shape == (1, 64, 12)
    # seeded: the same generator seed gives the same weights
    again = random_modules(torch.Generator().manual_seed(0), device="cpu")
    for a, b in zip(mods.local_model.state_dict().values(),
                    again.local_model.state_dict().values()):
        assert torch.equal(a, b)


def test_local_bridge_round_trip():
    v = perturbed_local_vars(jax.random.PRNGKey(1))
    sd = jax_local_to_torch(v["params"], v["batch_stats"])
    LocalStage().load_state_dict(sd)  # strict: every reference key, no other
    params, stats = tc.convert_local_stage(sd_numpy(sd))
    assert_trees_equal(params, v["params"])
    assert_trees_equal(stats, v["batch_stats"])


def test_global_bridge_round_trip():
    v = to_numpy(jmodels.GlobalStage().init(jax.random.PRNGKey(2), jnp.zeros((1, 16, 38))))
    sd = jax_global_to_torch(v["params"])
    GlobalStage().load_state_dict(sd)
    assert_trees_equal(tc.convert_global_stage(sd_numpy(sd)), v["params"])


def test_committed_local_stage_forward_parity():
    ckpt = load_checkpoint(os.path.join(WEIGHTS, "best_run_exp_local_stage"))
    variables = {"params": ckpt["params"], "batch_stats": ckpt["batch_stats"]}
    model = LocalStage()
    model.load_state_dict(jax_local_to_torch(to_numpy(ckpt["params"]),
                                             to_numpy(ckpt["batch_stats"])))
    model.eval()
    x = rng.uniform(0, 1, size=(64, 21, 21, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jmodels.LocalStage().apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    npt.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_committed_global_stage_forward_parity():
    ckpt = load_checkpoint(os.path.join(WEIGHTS, "best_run_exp_global_stage"))
    model = GlobalStage()
    model.load_state_dict(jax_global_to_torch(to_numpy(ckpt["params"])))
    model.eval()
    src = rng.normal(scale=0.5, size=(1, 64, 38)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jmodels.GlobalStage().apply({"params": ckpt["params"]},
                                                      jnp.asarray(src), train=False))
    with torch.no_grad():
        got = model(torch.from_numpy(src)).numpy()
    npt.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("layers", [1, 3])
def test_global_stage_layer_counts(layers):
    """Reduced-depth global stages (as the reduced-grid slice test uses)
    bridge and agree too."""
    jm = jmodels.GlobalStage(num_encoder_layers=layers)
    v = jm.init(jax.random.PRNGKey(layers), jnp.zeros((1, 32, 38)))
    model = GlobalStage(num_encoder_layers=layers)
    model.load_state_dict(jax_global_to_torch(to_numpy(v["params"])))
    model.eval()
    src = rng.normal(size=(2, 32, 38)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jm.apply(v, jnp.asarray(src), train=False))
    with torch.no_grad():
        got = model(torch.from_numpy(src)).numpy()
    npt.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
