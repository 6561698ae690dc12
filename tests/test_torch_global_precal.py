"""The port's global pre-calculation (``train/global_precal.py::
run_global_precal``) against the JAX package's, on the CPU: a tiny dataset
(41x41, 121 tokens a pair), random Flax local weights with perturbed
BatchNorm statistics, bridged into the port as a ``.pth`` and saved as an
Orbax checkpoint for the JAX package; both write ``params_src_{train,val}
.npy``, held to the colors' tolerance (rtol 2e-3, atol 2e-4,
tests/test_torch_wedge_kernels.py).
"""

import os

import numpy as np
import numpy.testing as npt
import torch

import jax
import jax.numpy as jnp

from blurry_edges_tpu import models as jmodels
from blurry_edges_tpu.config import get_args as jax_get_args
from blurry_edges_tpu.train import checkpoint as jckpt
from blurry_edges_tpu.train import global_precal as jprecal

from blurry_edges_tpu_torch.config import get_args
from blurry_edges_tpu_torch.train import global_precal
from blurry_edges_tpu_torch.models.weights import jax_local_to_torch

torch.set_num_threads(1)  # torch's and XLA-CPU's thread pools share this process

rng = np.random.default_rng(43)


def test_global_precal_matches_jax(tmp_path):
    v = jax.tree.map(np.asarray, jmodels.LocalStage().init(jax.random.PRNGKey(2),
                                                           jnp.zeros((1, 21, 21, 3))))
    v["batch_stats"] = jax.tree.map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), v["batch_stats"])
    n_train, n_val, H = 3, 2, 41
    data = {}
    for part, n in (("train", n_train), ("val", n_val)):
        alpha = rng.uniform(180, 200, n).astype(np.float32)
        yy, xx = np.mgrid[0:H, 0:H].astype(np.float32) / H
        base = np.stack([xx, yy, 0.5 * (xx + yy)], -1)
        clean = np.stack([np.stack([base, base[::-1]]) * rng.uniform(0.3, 1.0) for _ in range(n)])
        data[f"images_ny_{part}"] = np.round(clean * alpha[:, None, None, None, None]
                                             + rng.normal(0, 3, clean.shape)).clip(0).astype(np.float32)
        data[f"alphas_{part}"] = alpha
    for side in ("jax", "port"):
        os.makedirs(tmp_path / side)
        for name, arr in data.items():
            np.save(tmp_path / side / f"{name}.npy", arr)
    jckpt.save_checkpoint(str(tmp_path / "w" / "best_run_exp_local_stage"), v)
    os.makedirs(tmp_path / "pth")
    torch.save(jax_local_to_torch(v["params"], v["batch_stats"]),
               tmp_path / "pth" / "best_run_exp_local_stage.pth")

    argv = ["--img_size", str(H), str(H)]
    jargs = jax_get_args("global_pre", argv=argv + ["--data_path", str(tmp_path / "jax"),
                                                    "--model_path", str(tmp_path / "w")])
    with jax.default_matmul_precision("highest"):
        jprecal.run_global_precal(jargs, device_batch=2)
    args = get_args("global_pre", argv=argv + ["--data_path", str(tmp_path / "port"),
                                               "--model_path", str(tmp_path / "pth")])
    global_precal.run_global_precal(args, device_batch=2, device="cpu")
    for part, n in (("train", n_train), ("val", n_val)):
        ours = np.load(tmp_path / "port" / f"params_src_{part}.npy")
        theirs = np.load(tmp_path / "jax" / f"params_src_{part}.npy")
        assert ours.shape == theirs.shape == (n, 2, 121, 19) and ours.dtype == np.float32
        npt.assert_allclose(ours, theirs, rtol=2e-3, atol=2e-4, err_msg=part)
