"""The port's basic-shape generator (``data/shapes_gen.py``) against the JAX
package's.

- The rasterizer and a whole scene at 77x77 (the JAX package's own test
  size) from JAX's own draws: the test reproduces the nine draws of
  ``synthesize_image`` (shapes_gen.py:149-164) from its key and feeds them
  to ``synthesize_from_draws``. An SDF pixel on a knife edge (cos/sin or
  hypot one ulp apart) may flip: at most 0.1% of the fill and ring
  pixels; the rounded images may differ by at most 1 on at most 0.1% of
  their entries (a rounding tie moved by the blur's summation order), the
  other maps to rtol/atol 1e-5, the derivative maps to atol 1e-5 away
  from such entries.
- The noise by its statistics (torch cannot draw jax.random's numbers):
  integer counts in [0, alpha], mean error under 3 standard errors, the
  variance within 5% of gt + sigma^2 + 1/12.
- ``crop_patch`` on injected arrays with the same numpy seed writes the
  same ``patches/`` files as the JAX generator.
- ``ShapeDataset`` (its three modes) and ``BatchIterator`` on the
  generator's files give the JAX package's batches exactly.
"""

import math
import os

import numpy as np
import numpy.testing as npt
import torch

import jax
import jax.numpy as jnp

from blurry_edges_tpu.config import get_args as jax_get_args
from blurry_edges_tpu.data import datasets as jds
from blurry_edges_tpu.data import shapes_gen as jsg

from blurry_edges_tpu_torch.config import get_args
from blurry_edges_tpu_torch.data import datasets as ds
from blurry_edges_tpu_torch.data import shapes_gen as sg

torch.set_num_threads(1)  # torch's and XLA-CPU's thread pools share this process

H = 77


def jax_draws(key, cfg):
    """The draws of the JAX package's synthesize_image, line for line."""
    S = cfg.max_shapes
    kx = jax.random.split(key, 9)
    return dict(
        num_obj=jax.random.randint(kx[0], (), cfg.num_shape_lo, cfg.num_shape_hi),
        bg_color=jax.random.randint(kx[1], (3,), 0, 255).astype(jnp.float32),
        shape_type=jax.random.randint(kx[2], (S,), 0, 3),
        colors=jax.random.randint(kx[3], (S, 3), 0, 255).astype(jnp.float32),
        z=jnp.sort(jax.random.uniform(kx[4], (S,), minval=cfg.z_lo, maxval=cfg.z_hi))[::-1],
        center=jax.random.uniform(kx[5], (S, 2)) * jnp.array([cfg.W, cfg.H], jnp.float32),
        circle_r=jax.random.randint(kx[6], (S,), 0, int(cfg.max_size / 2)).astype(jnp.float32),
        rect_whd=jax.random.uniform(kx[7], (S, 3)) * jnp.array(
            [cfg.max_size, cfg.max_size, 180.0], jnp.float32),
        tri_raaa=jax.random.uniform(kx[8], (S, 4)) * jnp.array(
            [cfg.max_size, 2 * math.pi, 2 * math.pi, 2 * math.pi], jnp.float32))


def stacked(draws):
    out = {k: torch.from_numpy(np.stack([np.asarray(d[k]) for d in draws])) for k in draws[0]}
    out["num_obj"], out["shape_type"] = out["num_obj"].long(), out["shape_type"].long()
    return out


def test_rasterize_and_synthesize_match_jax():
    jcfg, cfg = jsg.ShapeGenConfig(H=H, W=H), sg.ShapeGenConfig(H=H, W=H)
    keys = jax.random.split(jax.random.PRNGKey(5), 5)
    dr = [jax_draws(k, jcfg) for k in keys]
    draws = stacked(dr)

    fills, rings = sg.rasterize_slots(draws["shape_type"], draws["center"], draws["circle_r"],
                                      draws["rect_whd"], draws["tri_raaa"], H, H)
    raster = jax.vmap(lambda t, c, r, rw, tr: jsg._rasterize_slot(t, c, r, rw, tr, jcfg))
    j = [raster(d["shape_type"], d["center"], d["circle_r"], d["rect_whd"], d["tri_raaa"])
         for d in dr]
    for ours, theirs in ((fills, [f for f, _ in j]), (rings, [r for _, r in j])):
        flips = np.mean(ours.numpy() != np.stack([np.asarray(t) for t in theirs]))
        assert flips <= 1e-3, flips

    ours = sg.synthesize_from_draws(draws, cfg)
    with jax.default_matmul_precision("highest"):
        theirs = [jsg.synthesize_image(k, jcfg) for k in keys]
    theirs = {k: np.stack([np.asarray(t[k]) for t in theirs]) for k in theirs[0]}
    assert set(ours) == set(theirs)
    d_img = np.abs(ours["imgs"].numpy() - theirs["imgs"])
    assert d_img.max() <= 1 and np.mean(d_img > 0) <= 1e-3
    for k in ("img_aif", "boundary_loc", "image_depth", "boundary_depth", "boundary_dist"):
        assert ours[k].shape == theirs[k].shape and ours[k].dtype == torch.float32, k
        npt.assert_allclose(ours[k].numpy(), theirs[k], rtol=1e-5, atol=1e-5, err_msg=k)
    # the Sobel maps where no rounded pixel under the 3x3 stencil differs
    calm = np.ones(theirs["deri"].shape, bool)
    moved = np.pad(d_img > 0, ((0, 0), (0, 0), (1, 1), (1, 1), (0, 0)))
    for di in range(3):
        for dj in range(3):
            calm &= ~moved[:, :, di:di + H, dj:dj + H]
    npt.assert_allclose(ours["deri"].numpy()[calm], theirs["deri"][calm], atol=1e-5)


def test_photon_noise_statistics():
    g = torch.Generator().manual_seed(3)
    levels = torch.tensor([0.0, 20.0, 128.0, 180.0])
    imgs = levels[:, None, None, None].expand(4, 64, 64, 3).contiguous()
    alpha = torch.full((4,), 190.0)
    gt, ny = sg.add_photon_noise(imgs, alpha, 2.0, g)
    assert torch.equal(ny, torch.round(ny)) and ny.min() >= 0 and (ny <= 190.0).all()
    npt.assert_allclose(gt[:, 0, 0, 0].numpy(), (levels / 255 * 190).numpy(), rtol=1e-6)
    for i in (1, 2, 3):       # away from the clips at 0 and alpha
        lam, x = gt[i, 0, 0, 0].item(), ny[i].double()
        var = lam + 4.0 + 1.0 / 12.0
        assert abs(x.mean().item() - lam) < 3 * math.sqrt(var / x.numel()), (i, x.mean(), lam)
        assert abs(x.var().item() / var - 1) < 0.05, (i, x.var(), var)


def gen_args(mod_get_args, path, n):
    return mod_get_args("data_gen_train_val", argv=[
        "--data_path", str(path), "--img_size", "41", "41",
        "--num_sample_train", str(n), "--num_sample_val", str(n)])


def test_crop_patch_picks_jax_patches(tmp_path):
    n, S = 6, 1234
    cfg = sg.ShapeGenConfig(H=41, W=41)
    scenes = sg.synthesize_from_draws(sg.draw_shapes(torch.Generator().manual_seed(7), n, cfg),
                                      cfg)
    alpha = np.linspace(181, 199, n).astype(np.float32)
    gt, ny = sg.add_photon_noise(scenes["imgs"], torch.from_numpy(alpha), 2.0,
                                 torch.Generator().manual_seed(8))
    arrays = {"images_aif": scenes["img_aif"], "images_gt": gt, "images_ny": ny,
              "boundary_locations": scenes["boundary_loc"],
              "image_depths": scenes["image_depth"], "boundary_depths": scenes["boundary_depth"],
              "derivative_maps": scenes["deri"]}
    arrays = {k: v.numpy() for k, v in arrays.items()}

    ours = sg.SyntheticShapeDataGenerator(gen_args(get_args, tmp_path / "port", n), device="cpu")
    os.makedirs(tmp_path / "port")
    for name, arr in arrays.items():
        np.save(tmp_path / "port" / f"{name}_train.npy", arr)
    ours.alpha_list, ours.rng = alpha, np.random.RandomState(S)
    ours.crop_patch(train=True)

    theirs = jsg.SyntheticShapeDataGenerator(gen_args(jax_get_args, tmp_path / "jax", n))
    for name, arr in arrays.items():       # the JAX generator keeps them as attributes
        setattr(theirs, name, arr)
    theirs.alpha_list = alpha
    np.random.seed(S)
    theirs.crop_patch(train=True)

    files = sorted(os.listdir(tmp_path / "jax" / "patches"))
    assert files == sorted(os.listdir(tmp_path / "port" / "patches")) and len(files) == 9
    for f in files:
        a = np.load(tmp_path / "port" / "patches" / f)
        b = np.load(tmp_path / "jax" / "patches" / f)
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32, f
        npt.assert_array_equal(a, b, err_msg=f)
    assert np.load(tmp_path / "port" / "patches" / "patches_ny_train.npy").shape == (2 * n, 21, 21, 3)


def test_datasets_match_jax(tmp_path):
    args = gen_args(get_args, tmp_path, 4)
    args.num_sample_val = 2
    sg.SyntheticShapeDataGenerator(args, device="cpu").run()
    rng = np.random.default_rng(2)
    for part, n in (("train", 4), ("val", 2)):
        np.save(tmp_path / f"params_src_{part}.npy",
                rng.normal(size=(n, 2, 121, 19)).astype(np.float32))
    for mode, path in (("local", tmp_path / "patches"), ("global_pre", tmp_path),
                       ("global", tmp_path)):
        for train in (True, False):
            ours = ds.ShapeDataset(str(path), train=train, mode=mode)
            theirs = jds.ShapeDataset(str(path), train=train, mode=mode)
            assert len(ours) == len(theirs)
            idx = np.array([1, 0])
            a, b = ours.batch(idx), theirs.batch(idx)
            assert set(a) == set(b), mode
            for k in b:
                npt.assert_array_equal(a[k], b[k], err_msg=f"{mode} {k}")
    for shuffle in (True, False):
        ours = list(ds.BatchIterator(10, 3, shuffle, seed=4))
        theirs = list(jds.BatchIterator(10, 3, shuffle, seed=4))
        assert len(ours) == 3 and all(np.array_equal(x, y) for x, y in zip(ours, theirs))
