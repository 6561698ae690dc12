"""``--serve_dtype bfloat16`` in the port, against the JAX package's.

- The weights stay float32 (the state dicts' tensors and keys) while every
  layer with a compute dtype computes in bfloat16.
- Each network's bfloat16 output against the Flax network's bfloat16
  output on the same input and the same (bridged) float32 weights: the gap
  is no larger than the Flax network's own bfloat16-vs-float32 gap there,
  at the 99th percentile and at the maximum. The two frameworks round the
  same operations to bfloat16 but differ in float32 accumulation order and
  in their bfloat16 transcendentals (XLA's tanh, exp and log1p are not
  torch's), so bit equality is not expected; a float32 operation where
  Flax rounds (or the reverse) would put the gap at the bfloat16-vs-float32
  gap's size.
- The NN boundary is exact on the CPU: the bfloat16 estimator equals, bit
  for bit, the float32 chain (colors, tokens, render, fold, threshold) run
  on the bfloat16 networks' outputs cast to float32 (the port's form of
  tests/test_serve_dtype.py::test_bf16_nn_boundary_is_exact).
- ``slow``: committed-weight metrics in bfloat16 track float32 over a few
  pairs of the test set, as tests/test_serve_dtype.py holds the JAX
  package.
"""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from blurry_edges_tpu import models as jmodels

from blurry_edges_tpu_torch.config import CamConfig, GridConfig, PatchConfig
from blurry_edges_tpu_torch.eval import pipeline as pipe
from blurry_edges_tpu_torch.models.layers import set_compute_dtype
from blurry_edges_tpu_torch.ops.dfd import DfDSolver
from blurry_edges_tpu_torch.ops.params import denormalize_global_eval
from blurry_edges_tpu_torch.ops.patchify import unfold
from blurry_edges_tpu_torch.ops.wedge import params2etas
from blurry_edges_tpu_torch.models.weights import random_modules
from tests.test_torch_pipeline import bridged_modules, to_numpy
from tests.test_torch_unet import perturbed_unet_vars

torch.set_num_threads(1)  # torch's and XLA-CPU's thread pools share this process

rng = np.random.default_rng(23)
H = 41


def perturbed_local_vars(seed=0):
    """Flax LocalStage variables from its init, BatchNorm means from
    U(-0.1, 0.1), variances from U(0.5, 1.5), U(-0.1, 0.1) added to every
    scale and bias: an output that varies from patch to patch."""
    v = to_numpy(jmodels.LocalStage().init(jax.random.PRNGKey(seed), jnp.zeros((1, 21, 21, 3))))
    v["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda path, a: rng.uniform(*((-0.1, 0.1) if path[-1].key == "mean" else (0.5, 1.5)),
                                    a.shape).astype(np.float32), v["batch_stats"])
    v["params"] = jax.tree.map(
        lambda a: (a + rng.uniform(-0.1, 0.1, a.shape)).astype(np.float32) if a.ndim == 1 else a,
        v["params"])
    return v


@pytest.fixture(scope="module")
def nets():
    layers = 2
    lv = perturbed_local_vars()
    gv = to_numpy(jmodels.GlobalStage(num_encoder_layers=layers).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 121, 38))))
    uv = perturbed_unet_vars(seed=2)
    mods = bridged_modules(lv, gv, layers, uv)
    return dict(
        local=(lambda dtype: jmodels.LocalStage(dtype=dtype), lv, mods.local_model,
               rng.uniform(0, 1, (512, 21, 21, 3)).astype(np.float32), None),
        glob=(lambda dtype: jmodels.GlobalStage(num_encoder_layers=layers, dtype=dtype), gv,
              mods.global_model, rng.normal(0, 1, (1, 121, 38)).astype(np.float32), None),
        unet=(lambda dtype: jmodels.UNet(dtype=dtype), uv, mods.unet_model,
              rng.uniform(0, 1.2, (1, 41, 41, 1)).astype(np.float32), (0, 3, 1, 2)))


def test_params_stay_float32_under_bf16_modules():
    """A bfloat16 model keeps float32 weights under the float32 model's keys
    (random_modules builds both from the same draws), and every layer with
    a compute dtype computes in bfloat16."""
    f32 = random_modules(torch.Generator().manual_seed(5), device="cpu", unet=True)
    b16 = random_modules(torch.Generator().manual_seed(5), device="cpu", unet=True,
                         dtype=torch.bfloat16)
    for a, b in zip((f32.local_model, f32.global_model, f32.unet_model),
                    (b16.local_model, b16.global_model, b16.unet_model)):
        sa, sb = a.state_dict(), b.state_dict()
        assert list(sa) == list(sb)
        for k in sa:
            assert sb[k].dtype == sa[k].dtype and torch.equal(sa[k], sb[k]), k
        layers = [m for m in b.modules() if hasattr(type(m), "compute_dtype")]
        assert layers and all(m.compute_dtype == torch.bfloat16 for m in layers)
        assert all(m.compute_dtype == torch.float32 for m in a.modules()
                   if hasattr(type(m), "compute_dtype"))
    with pytest.raises(ValueError, match="compute dtype"):
        set_compute_dtype(copy.deepcopy(f32.local_model), torch.float16)


def _gap(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).ravel()
    return np.quantile(d, 0.99), d.max()


@pytest.mark.parametrize("net", ["local", "glob", "unet"])
def test_network_bf16_matches_flax_bf16(nets, net):
    make, variables, model, x, perm = nets[net]
    with jax.default_matmul_precision("highest"):
        flax32 = np.asarray(make(jnp.float32).apply(variables, x, train=False))
        flax16 = np.asarray(make(jnp.bfloat16).apply(variables, x, train=False)
                            .astype(jnp.float32))
    ours_model = set_compute_dtype(copy.deepcopy(model), torch.bfloat16)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        ours = ours_model(xt if perm is None else xt.permute(*perm))
    assert ours.dtype == torch.bfloat16
    ours = ours.float()
    if perm is not None:
        ours = ours.permute(0, 2, 3, 1)
    ours = ours.numpy()
    assert np.std(flax32) > 1e-3                    # an output that varies
    p99_ref, max_ref = _gap(flax16, flax32)         # Flax's own bf16 error
    p99, mx = _gap(ours, flax16)
    assert p99_ref > 0                              # bf16 really ran
    assert p99 <= p99_ref and mx <= max_ref, (net, p99, p99_ref, mx, max_ref)


def test_bf16_nn_boundary_is_exact():
    """Only the networks run bfloat16: the estimator's maps equal, bit for
    bit, the float32 chain run on the bfloat16 networks' outputs cast to
    float32."""
    from blurry_edges_tpu_torch.ops.wedge_cuda import wedge_colors
    from blurry_edges_tpu_torch.ops.params import (normalize_token_features,
                                                   wrap_local_params)

    mods = random_modules(torch.Generator().manual_seed(7), device="cpu",
                          dtype=torch.bfloat16)
    grid, patch_cfg, cam = GridConfig(H=H, W=H), PatchConfig(), CamConfig()
    img = torch.from_numpy(rng.uniform(0, 1, (2, H, H, 3)).astype(np.float32))
    got = pipe.make_depth_estimator(mods, patch_cfg, grid, cam, device="cpu")(img)
    for k in ("confidence", "global_depth", "depth_final"):
        assert got[k].dtype == torch.float32

    L, Hp, R = grid.num_tokens, grid.H_patches, grid.R
    with torch.no_grad():
        patches = unfold(img, R, grid.stride)                        # (2, Hp, Wp, R, R, 3)
        flat = patches.reshape(2 * L, R, R, 3)
        raw = mods.local_model(flat)
        assert raw.dtype == torch.bfloat16
        params = wrap_local_params(raw.float())
        tokens = normalize_token_features(params, wedge_colors(params, flat, patch_cfg))
        src = tokens.reshape(2, L, 19).permute(1, 0, 2).reshape(1, L, 38)
        est = mods.global_model(src)
        assert est.dtype == torch.bfloat16
        den = denormalize_global_eval(est.float()).reshape(1, Hp, Hp, 12)
        rend = pipe.render_full(den[..., :8].contiguous(), params2etas(den[..., 8:]).contiguous(),
                                patches[None], patch_cfg, DfDSolver.from_config(cam, patch_cfg),
                                10.39, False)
        want = pipe.fold_outputs(rend, grid)
        want["depth_final"] = torch.where(want["confidence"] > 0.05, want["global_depth"], 0.0)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.slow
def test_bf16_committed_weights_track_f32(tmp_path, capsys):
    """The committed local and global stages (exported to .pth by the root
    tool) over 4 seeded 147x147 pairs: bfloat16 metrics within the JAX
    package's bf16 tolerances of float32 (tests/test_serve_dtype.py)."""
    import export_torch_assets as tool
    from blurry_edges_tpu_torch.models.weights import load_inference_modules
    from tests.test_torch_eval import eval_args, write_test_set

    root = Path(__file__).resolve().parent.parent
    tool.export_weights(str(root / "pretrained_weights"), str(tmp_path),
                        ["best_run_exp_local_stage", "best_run_exp_global_stage"])
    data = write_test_set(tmp_path / "data", 4, 147, 12)
    args = eval_args(data, size=147, model_path=str(tmp_path))
    res = {}
    for dtype in ("float32", "bfloat16"):
        args.serve_dtype = dtype
        res[dtype] = pipe.run_eval(args, load_inference_modules(args, device="cpu"),
                                   device="cpu")
    out = capsys.readouterr().out
    assert "Image pair #3:" in out
    for k in ("delta1", "delta2", "delta3", "rmse", "absrel"):
        assert np.isfinite(res["bfloat16"][k]), k
        np.testing.assert_allclose(res["bfloat16"][k], res["float32"][k], rtol=0.25,
                                   atol=0.05, err_msg=k)
