"""The port's LocalStage BatchNorm against Flax's ``nn.BatchNorm`` in train
mode.

Flax moves the running statistics by momentum 0.99 toward the batch mean
and the biased batch variance; the port's BatchNorm layers do the same
(torch's stock update keeps 0.9 and the unbiased variance). One train-mode
forward of both models from the same bridged weights and perturbed
statistics, on one numpy batch: the updated running means and variances
agree to rtol 1e-5 (float32 on both sides, the convolutions summed in
another order), in the 2d layers of the trunk and the 1d layer of the head.
Eval mode still normalises by the running statistics, as before: the
outputs agree with Flax's eval forward at the tolerances of
tests/test_torch_models.py (rtol 1e-4, atol 1e-5).
"""

import numpy as np
import numpy.testing as npt
import pytest
import torch

import jax
import jax.numpy as jnp

from blurry_edges_tpu import models as jmodels

from blurry_edges_tpu_torch.models.local_stage import LocalStage
from blurry_edges_tpu_torch.models.weights import jax_local_to_torch

torch.set_num_threads(1)  # torch's and XLA-CPU's thread pools share this process

rng = np.random.default_rng(21)
N = 16


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def one_train_step():
    """(port state dict after one train forward, Flax's, the batch, the
    Flax variables before, the port's and Flax's train outputs)."""
    v = to_numpy(jmodels.LocalStage().init(jax.random.PRNGKey(3), jnp.zeros((1, 21, 21, 3))))
    v["batch_stats"] = jax.tree.map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), v["batch_stats"])
    x = rng.uniform(0, 1, (N, 21, 21, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        y_jax, new = jmodels.LocalStage().apply(v, jnp.asarray(x), train=True,
                                                mutable=["batch_stats"])
    want = jax_local_to_torch(v["params"], to_numpy(new["batch_stats"]))
    model = LocalStage()
    model.load_state_dict(jax_local_to_torch(v["params"], v["batch_stats"]))
    model.train()
    with torch.no_grad():
        y = model(torch.from_numpy(x))
    return model.state_dict(), want, x, v, y.numpy(), np.asarray(y_jax)


@pytest.mark.parametrize("kind", ["2d", "1d"])
def test_running_stats_match_flax(one_train_step, kind):
    got, want, *_ = one_train_step
    names = [k[:-len(".running_mean")] for k in want if k.endswith(".running_mean")]
    names = [n for n in names if (n == "fc.2") == (kind == "1d")]
    assert names
    for n in names:
        for stat in ("running_mean", "running_var"):
            npt.assert_allclose(got[f"{n}.{stat}"].numpy(), want[f"{n}.{stat}"].numpy(), rtol=1e-5,
                                err_msg=f"{n}.{stat}")
        assert int(got[f"{n}.num_batches_tracked"]) == 1


def test_train_output_matches_flax(one_train_step):
    *_, y, y_jax = one_train_step
    npt.assert_allclose(y, y_jax, rtol=1e-4, atol=1e-5)


def test_eval_output_unchanged(one_train_step):
    _, _, x, v, *_ = one_train_step
    model = LocalStage()
    model.load_state_dict(jax_local_to_torch(v["params"], v["batch_stats"]))
    stock = {k: t.clone() for k, t in model.state_dict().items()}
    model.eval()
    with torch.no_grad():
        y = model(torch.from_numpy(x)).numpy()
    with jax.default_matmul_precision("highest"):
        y_jax = np.asarray(jmodels.LocalStage().apply(v, jnp.asarray(x), train=False))
    npt.assert_allclose(y, y_jax, rtol=1e-4, atol=1e-5)
    for k, t in model.state_dict().items():  # eval leaves the statistics alone
        assert torch.equal(t, stock[k]), k
