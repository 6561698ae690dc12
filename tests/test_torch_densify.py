"""The port's depth-completion trainer (``train/densify.py``) against the JAX
package's, on the same numpy inputs, on the CPU.

- ``make_sparse_from_gt`` given the JAX package's own draws from a key
  (band width, keep field, noise field, split from it as JAX splits them):
  the sparse map to 1e-6 and the kept mask exactly; the port's own draws
  by their statistics on 147x147 fields: widths in 3..10, a drop share of
  0.15 +- 0.02, a noise std of 0.02 +- 0.002;
- ``masked_mse``, ``grad_matching`` and the flips (the flip booleans
  drawn as JAX draws them from its key) on fixed batches: rtol 1e-6, the
  flips exactly;
- ``flax_default_init`` on the U-Net: each kernel's std within 5% of
  sqrt(1 / fan_in) (Flax's fans, kh * kw * in), no draw beyond two of its
  standard deviations, zero biases, unit BatchNorm scales and fresh
  running statistics, as the Flax U-Net's own ``init`` gives them;
- from bridged weights (``jax_unet_to_torch``, BatchNorm statistics
  perturbed) at 41x41: the eval step to rtol 1e-4; one train step with
  gradient matching and the flips to rtol 1e-4 (loss), 1e-5 (running
  statistics), and Adam's first update (about the gradient's sign, over
  lr) within 2e-3 of optax's wherever the gradient is at least 0.03 of its
  RMS, over 70% of the entries (the JAX package's float32 train-mode
  BatchNorm backward is the less exact of the two, ROADMAP.md section 3;
  measured: 1.2e-4 apart at most there, and none apart from 0.01 of the
  RMS up; on other data one sign apart at 0.01);
- the sparse-map loop's chunks and tail padding with a stand-in
  estimator (order kept, the pad cut off, (B, 1, H, W) -> (B, H, W));
- ``densify_train --cuda cpu`` on a tiny generated set: the log, the curve
  and the checkpoint written, and ``eval --densify pp --cuda cpu`` serving
  that checkpoint;
- (slow) ``_pipeline_sparse_depths`` and ``_realistic_sparse_pairs``
  against the JAX package's with the same bridged random modules at
  41x41: the confidence threshold's knife edges flip a few pixels between
  0 and a depth, so the share of entries apart by more than 5e-3 is held
  under 2% and the rest to 5e-3.
"""

import functools
import math
import types

import numpy as np
import numpy.testing as npt
import pytest
import torch

import jax
import jax.numpy as jnp

from blurry_edges_tpu import models as jmodels
from blurry_edges_tpu.train import densify as jdensify
from blurry_edges_tpu.train import local as jlocal

from blurry_edges_tpu_torch import cli
from blurry_edges_tpu_torch.models.unet import UNet
from blurry_edges_tpu_torch.train import densify, optim
from blurry_edges_tpu_torch.utils.weights import jax_unet_to_torch, random_modules
from tests.test_torch_unet import perturbed_unet_vars

torch.set_num_threads(1)  # torch's and XLA-CPU's thread pools share this process

rng = np.random.default_rng(23)
H, LR = 41, 1e-3


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def boundaries(B, size):
    """Boundary maps as the generator writes them (255 on boundary pixels):
    a few random lines each, one map left empty."""
    out = np.zeros((B, size, size), np.float32)
    for b in range(B - 1):
        for _ in range(2):
            if rng.uniform() < 0.5:
                out[b, rng.integers(0, size), :] = 255.0
            else:
                out[b, :, rng.integers(0, size)] = 255.0
    return out


def depth_maps(B, size):
    return rng.uniform(0.75, 1.18, (B, size, size)).astype(np.float32)


def jax_draws(key, shape):
    """The draws of the JAX package's make_sparse_from_gt from ``key``."""
    k1, k2, k3 = jax.random.split(key, 3)
    return dict(width=np.float32(jax.random.randint(k1, (), 3, 11)),
                keep=np.asarray(jax.random.uniform(k2, shape)),
                noise=np.asarray(jax.random.normal(k3, shape)))


def test_sparse_transform_matches_jax_draws():
    B = 4
    depth, bnd = depth_maps(B, H), boundaries(B, H)
    for b in range(B):
        key = jax.random.PRNGKey(100 + b)
        j_sparse, j_mask = jdensify.make_sparse_from_gt(key, jnp.asarray(depth[b]),
                                                        jnp.asarray(bnd[b]))
        d = {k: torch.tensor(v) for k, v in jax_draws(key, (H, H)).items()}
        sparse, mask = densify.make_sparse_from_gt(torch.from_numpy(depth[b]),
                                                   torch.from_numpy(bnd[b]), **d)
        npt.assert_array_equal(mask.numpy(), np.asarray(j_mask))
        npt.assert_allclose(sparse.numpy(), np.asarray(j_sparse), rtol=1e-6, atol=1e-6)
        assert 0 < mask.float().mean() < 1 or b == B - 1


def test_sparse_draws_statistics():
    B, S = 64, 147
    d = densify.sparse_draws(torch.Generator().manual_seed(0), B, S, S)
    w = d["width"].numpy()
    assert w.min() >= 3 and w.max() <= 10 and set(w.tolist()) == set(range(3, 11))
    depth = torch.full((B, S, S), 0.9)
    everywhere = torch.full((B, S, S), 255.0)          # the band covers every pixel
    sparse, mask = densify.make_sparse_from_gt(depth, everywhere, **d)
    assert abs(1.0 - mask.float().mean().item() - 0.15) < 0.02
    noise = (sparse[mask] / 0.9 - 1.0).std().item()
    assert abs(noise - 0.02) < 0.002
    assert (sparse[~mask] == 0).all() and sparse.max() <= 1.18


def test_losses_and_flips_match_jax():
    B = 3
    pred, target = depth_maps(B, H), depth_maps(B, H)
    sp = np.where(rng.uniform(size=pred.shape) < 0.3, pred, 0.0).astype(np.float32)
    tp, tt = torch.from_numpy(pred), torch.from_numpy(target)
    npt.assert_allclose(densify.masked_mse(tp, tt).item(),
                        float(jdensify.masked_mse(jnp.asarray(pred), jnp.asarray(target))),
                        rtol=1e-6)
    npt.assert_allclose(densify.grad_matching(tp, tt).item(),
                        float(jdensify.grad_matching(jnp.asarray(pred), jnp.asarray(target))),
                        rtol=1e-6)
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        j_sp, j_tg = jdensify._rand_flips(key, jnp.asarray(sp), jnp.asarray(target))
        flips = torch.tensor(np.asarray(jax.random.bernoulli(key, 0.5, (B, 2))))
        p_sp, p_tg = densify.rand_flips(flips, torch.from_numpy(sp), tt)
        npt.assert_array_equal(p_sp.numpy(), np.asarray(j_sp))
        npt.assert_array_equal(p_tg.numpy(), np.asarray(j_tg))
    assert densify.flip_draws(torch.Generator().manual_seed(0), 4000).float().mean().item() \
        == pytest.approx(0.5, abs=0.02)


def test_flax_default_init_unet():
    model = UNet()
    optim.flax_default_init(model, torch.Generator().manual_seed(0))
    v = to_numpy(jmodels.UNet().init(jax.random.PRNGKey(0), jnp.zeros((1, H, H, 1))))
    theirs = jax_unet_to_torch(v["params"], v["batch_stats"])
    n_kernels = 0
    for name, mod in model.named_modules():
        if isinstance(mod, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            w = mod.weight
            i, kh, kw = ((w.shape[0], w.shape[2], w.shape[3])
                         if isinstance(mod, torch.nn.ConvTranspose2d) else w.shape[1:])
            want = math.sqrt(1.0 / (i * kh * kw))
            for got in (w, theirs[f"{name}.weight"]):
                if got.numel() >= 4096:
                    assert abs(got.std().item() / want - 1) < 0.05, (name, got.std().item(), want)
                assert got.abs().max().item() <= 2 * want / optim._TRUNC_STD + 1e-7, name
            if mod.bias is not None:
                assert (mod.bias == 0).all() and (theirs[f"{name}.bias"] == 0).all(), name
            n_kernels += 1
        elif isinstance(mod, torch.nn.BatchNorm2d):
            assert (mod.weight == 1).all() and (mod.bias == 0).all(), name
            assert (mod.running_mean == 0).all() and (mod.running_var == 1).all(), name
            for k in ("weight", "bias", "running_mean", "running_var"):
                npt.assert_array_equal(getattr(mod, k).detach().numpy(),
                                       theirs[f"{name}.{k}"].numpy())
    assert n_kernels == 23
    with pytest.raises(NotImplementedError, match="ConvTranspose2d"):
        optim.xavier_reinit(UNet(), torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def unet_state():
    """Flax U-Net variables (BatchNorm statistics perturbed), a batch of
    sparse inputs and dense targets at 41x41."""
    v = perturbed_unet_vars(seed=1)
    r = np.random.default_rng(31)
    target = r.uniform(0.75, 1.18, (2, H, H)).astype(np.float32)
    sparse = np.where(r.uniform(size=target.shape) < 0.4, target, 0.0).astype(np.float32)
    return v, sparse, target


def bridged(v):
    model = UNet()
    model.load_state_dict(jax_unet_to_torch(v["params"], v["batch_stats"]))
    return model


def test_eval_step_matches_jax(unet_state):
    v, sparse, target = unet_state
    tx = jlocal.make_optimizer(LR)
    state = jlocal.TrainState(params=v["params"], batch_stats=v["batch_stats"],
                              opt_state=tx.init(v["params"]), step=jnp.zeros((), jnp.int32))
    _, j_eval = jdensify.make_steps(jmodels.UNet(), tx)
    with jax.default_matmul_precision("highest"):
        want = float(j_eval(state, jnp.asarray(sparse), jnp.asarray(target)))
    model = bridged(v)
    _, p_eval = densify.make_steps(model, optim.make_optimizer(model.parameters(), LR))
    got = p_eval(torch.from_numpy(sparse)[:, None], torch.from_numpy(target)).item()
    npt.assert_allclose(got, want, rtol=1e-4)


def test_train_step_matches_jax(unet_state):
    """Gradient matching (weight 0.5) and the flips on, as the JAX step
    draws them from its key."""
    v, sparse, target = unet_state
    tx = jlocal.make_optimizer(LR)
    state = jlocal.TrainState(params=v["params"], batch_stats=v["batch_stats"],
                              opt_state=tx.init(v["params"]), step=jnp.zeros((), jnp.int32))
    j_train, _ = jdensify.make_steps(jmodels.UNet(), tx, grad_loss_w=0.5, augment=True)
    key = jax.random.PRNGKey(9)
    with jax.default_matmul_precision("highest"):
        new_state, j_loss = j_train(state, jnp.asarray(sparse), jnp.asarray(target), key)
    j_after = jax_unet_to_torch(to_numpy(new_state.params), to_numpy(new_state.batch_stats))
    flips = torch.tensor(np.asarray(jax.random.bernoulli(key, 0.5, (2, 2))))
    assert flips.any()

    model = bridged(v)
    p_train, _ = densify.make_steps(model, optim.make_optimizer(model.parameters(), LR),
                                    grad_loss_w=0.5, augment=True)
    before = {k: t.clone() for k, t in model.state_dict().items()}
    loss = p_train(torch.from_numpy(sparse)[:, None], torch.from_numpy(target), flips).item()
    npt.assert_allclose(loss, float(j_loss), rtol=1e-4)
    after = model.state_dict()
    for k in after:
        if k.endswith(("running_mean", "running_var")):
            npt.assert_allclose(after[k].numpy(), j_after[k].numpy(), rtol=1e-5, atol=1e-7,
                                err_msg=k)
    names = [n for n, _ in model.named_parameters()]
    grad = np.concatenate([p.grad.numpy().ravel() for p in model.parameters()]).astype(np.float64)

    def upd(sd):
        return np.concatenate([((sd[n].numpy() - before[n].numpy()) / LR).ravel()
                               for n in names]).astype(np.float64)

    d = np.abs(upd(after) - upd(j_after))
    clear = np.abs(grad) >= 0.03 * np.sqrt(np.mean(grad ** 2))
    assert clear.mean() > 0.7 and d[clear].max() < 2e-3 and d.max() <= 2.0, \
        (clear.mean(), d[clear].max(), d.max())


def test_sparse_loop_chunks_and_pads(monkeypatch):
    """Chunks of 2 over 5 pairs (the last padded with its last pair and the
    pad cut off), sample order kept, depth_final's (B, 1, H, W) -> (B, H, W),
    the realistic source's images divided by alpha."""
    from blurry_edges_tpu_torch.config import get_args
    from blurry_edges_tpu_torch.data import datasets
    from blurry_edges_tpu_torch.eval import pipeline

    n, S = 5, 21
    seen = []

    class FakeShapes:
        def __init__(self, path, train, mode):
            assert mode == "global_pre"

        def __len__(self):
            return n

        def batch(self, idx):
            ids = np.asarray(idx, np.float32)[:, None, None, None, None]
            return {"img_ny": np.broadcast_to(ids, (len(idx), 2, S, S, 3)).copy()}

    def fake_make(mods, patch_cfg, grid, cam, densify=None, device="cuda"):
        assert densify is None and (grid.H, grid.W) == (S, S)

        def estimate(imgs):
            seen.append(len(imgs))
            ids = torch.from_numpy(np.asarray(imgs)[:, 0, 0, 0, 0])
            return {"depth_final": ids[:, None, None, None].expand(len(imgs), 1, S, S).clone()}

        return estimate

    monkeypatch.setattr(datasets, "ShapeDataset", FakeShapes)
    monkeypatch.setattr(pipeline, "make_batched_depth_estimator", fake_make)
    args = get_args("local_train", argv=["--img_size", str(S), str(S)])
    out = densify._pipeline_sparse_depths(args, "val", modules=object(), chunk=2, device="cpu")
    assert out.shape == (n, S, S) and seen == [2, 2, 2]
    npt.assert_array_equal(out[:, 3, 4], np.arange(n, dtype=np.float32))
    assert densify._pipeline_sparse_depths(args, "val", object(), n=0, device="cpu").shape \
        == (0, S, S)

    class FakeTest:
        def __init__(self, path):
            self.img_ny = np.broadcast_to((2.0 * np.arange(3, dtype=np.float32))[
                :, None, None, None, None], (3, 2, S, S, 3)).copy()
            self.alpha = np.full(3, 2.0, np.float32)
            self.depth_map = np.ones((3, S, S), np.float32)

        def __len__(self):
            return 3

    monkeypatch.setattr(datasets, "TestDataset", FakeTest)
    seen.clear()
    sparse, depth = densify._realistic_sparse_pairs(args, "unused", object(), chunk=4,
                                                    device="cpu")
    assert seen == [4] and depth.shape == (3, S, S)
    npt.assert_array_equal(sparse[:, 0, 0], np.arange(3, dtype=np.float32))


def save_modules(path, unet=False):
    """Seeded random local and global stages (and a U-Net) as the
    ``<name>.pth`` files ``load_inference_modules`` reads."""
    mods = random_modules(torch.Generator().manual_seed(4), "cpu", unet=unet)
    path.mkdir(parents=True, exist_ok=True)
    torch.save(mods.local_model.state_dict(), path / "best_run_exp_local_stage.pth")
    torch.save(mods.global_model.state_dict(), path / "best_run_exp_global_stage.pth")


@pytest.fixture(scope="module")
def shape_set(tmp_path_factory):
    root = tmp_path_factory.mktemp("densify")
    cli.main(["gen_trainval", "--cuda", "cpu", "--data_path", str(root / "data"),
              "--img_size", str(H), str(H), "--num_sample_train", "16", "--num_sample_val", "8"])
    return root


def test_cli_trains_and_eval_serves_the_checkpoint(shape_set, monkeypatch, capsys):
    root = shape_set
    w = root / "w"
    save_modules(w)
    monkeypatch.setattr(densify, "run_densify_training",
                        functools.partial(densify.run_densify_training, epochs=2))
    # --epoch_num is ignored, as in the JAX package (the epochs patched to 2)
    res = cli.main(["densify_train", "--cuda", "cpu", "--img_size", str(H), str(H),
                    "--data_path", str(root / "data" / "patches"), "--epoch_num", "7",
                    "--log_path", str(root / "logs"), "--model_path", str(w)])
    assert res["steps"] == 2 * 2 and res["curve"].shape == (2,) and np.isfinite(res["curve"]).all()
    assert (res["n_train"], res["n_val"]) == (16, 8)
    assert (root / "logs" / "exp_depth_completion_training.txt").exists()
    np.testing.assert_array_equal(np.load(root / "logs" / "loss_curve_exp_depth_completion.npy"),
                                  res["curve"])
    assert (w / "best_run_exp_depth_completion_pp.pth").exists()

    from tests.test_torch_parallel import write_test_set
    write_test_set(root / "t41", 2, H, 3)
    capsys.readouterr()
    out = cli.eval_main(["--cuda", "cpu", "--img_size", str(H), str(H), "--densify", "pp",
                         "--data_path", str(root / "t41"), "--model_path", str(w),
                         "--log_path", str(root / "logs_eval"), "--vis_max", "1"])
    log = capsys.readouterr().out
    assert f"unet stage <- {w / 'best_run_exp_depth_completion_pp.pth'}" in log
    assert all(math.isfinite(out[k]) for k in ("delta1", "rmse", "absrel"))


@pytest.mark.slow
def test_pipeline_sparse_maps_match_jax(shape_set, tmp_path):
    """Both sources through both packages' estimators, the same bridged
    random weights (2 global layers), chunks of 2 over 3 shape pairs and 2
    realistic ones (tail padding on both)."""
    from blurry_edges_tpu.eval.pipeline import InferenceModules as JaxModules
    from tests.test_torch_parallel import write_test_set
    from tests.test_torch_pipeline import bridged_modules

    key = jax.random.PRNGKey(1)
    jl, jg = jmodels.LocalStage(), jmodels.GlobalStage(num_encoder_layers=2)
    lv = to_numpy(jl.init(key, jnp.zeros((1, 21, 21, 3))))
    lv["batch_stats"] = jax.tree.map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), lv["batch_stats"])
    gv = to_numpy(jg.init(key, jnp.zeros((1, ((H - 21) // 2 + 1) ** 2, 38))))
    jmods = JaxModules(local_model=jl, local_vars=lv, global_model=jg, global_vars=gv)
    mods = bridged_modules(lv, gv, 2)
    write_test_set(tmp_path / "real", 2, H, 5)
    args = types.SimpleNamespace(
        data_path=str(shape_set / "data"), R=21, stride=2, img_size=[H, H], w=1.0,
        alpha_lambda=5e-3, mag=4.0, cam_params={"s": 0.1104, "rho_1": 10.0, "rho_2": 10.2,
                                                "sigma_cam": 0.003, "pixel_pitch": 5.86e-6})
    with jax.default_matmul_precision("highest"):
        j_shapes = jdensify._pipeline_sparse_depths(args, "val", jmods, 3, chunk=2)
        j_real, j_depth = jdensify._realistic_sparse_pairs(args, str(tmp_path / "real"), jmods,
                                                           chunk=2)
    p_shapes = densify._pipeline_sparse_depths(args, "val", mods, 3, chunk=2, device="cpu")
    p_real, p_depth = densify._realistic_sparse_pairs(args, str(tmp_path / "real"), mods,
                                                      chunk=2, device="cpu")
    npt.assert_array_equal(p_depth, np.asarray(j_depth))
    for ours, theirs in ((p_shapes, j_shapes), (p_real, j_real)):
        theirs = np.asarray(theirs)
        assert ours.shape == theirs.shape and (theirs > 0).any()
        far = np.abs(ours - theirs) > 5e-3
        assert far.mean() < 0.02, far.mean()
