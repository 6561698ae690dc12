"""The port's block-tiled estimator (587x587 and other 147 + 4k sizes)
against the JAX package's ``eval/pipeline_big.py``.

- ``block_geometry`` and ``stitch_maps`` equal the JAX package's at 587x587
  and at smaller geometries.
- The estimator at a reduced geometry (49x49 blocks over a 71x71 image, a
  2-patch margin: 2x2 blocks, a 26x26 big patch grid, as
  tests/test_big_sharded.py), random Flax weights bridged into the port (2
  global layers), against JAX's ``make_big_depth_estimator``, with the
  147x147 slice's tolerances (tests/test_torch_pipeline.py::
  assert_maps_close). Its maps are the same for every ``block_chunk``.
- ``run_eval_big`` scores the estimator's maps as ``run_eval`` does, with
  the exclusion of empty images.
- ``slow``: one 587x587 pair through the committed weights (the big path's
  own global stage) in both packages.
"""

from pathlib import Path

import numpy as np
import numpy.testing as npt
import pytest
import torch

import jax
import jax.numpy as jnp

from blurry_edges_tpu import models as jmodels
from blurry_edges_tpu.config import (CamConfig as JaxCam, GridConfig as JaxGrid,
                                     PatchConfig as JaxPatch)
from blurry_edges_tpu.eval import pipeline_big as jbig
from blurry_edges_tpu.eval.pipeline import InferenceModules as JaxModules

from blurry_edges_tpu_torch.config import CamConfig, GridConfig, PatchConfig, get_args
from blurry_edges_tpu_torch.eval import pipeline_big as big
from blurry_edges_tpu_torch.eval.metrics import eval_depth
from tests.test_torch_eval import LINE, write_test_set
from tests.test_torch_pipeline import assert_maps_close, bridged_modules, to_numpy
from tests.test_torch_serve_dtype import perturbed_local_vars

torch.set_num_threads(1)  # torch's and XLA-CPU's thread pools share this process

ROOT = Path(__file__).resolve().parent.parent
rng = np.random.default_rng(17)
BLOCK, BIG, N_MARGIN = 49, 71, 2
# a cheaper geometry for the port-only tests: 41x41 blocks (121 tokens) over
# 55x55, 2x2 blocks
SMALL_BLOCK, SMALL_BIG = 41, 55


@pytest.mark.parametrize("img,big_img,margin", [(147, 587, 10), (147, 323, 10),
                                                (BLOCK, BIG, N_MARGIN), (49, 85, 3)])
def test_geometry_and_stitch_match_jax(img, big_img, margin):
    ours = big.block_geometry([img, img], [big_img, big_img], 21, 2, margin)
    theirs = jbig.block_geometry([img, img], [big_img, big_img], 21, 2, margin)
    assert ours == theirs
    (_, _), (nb, _) = ours
    hp, hp_big = (img - 21) // 2 + 1, (big_img - 21) // 2 + 1
    for a, b in zip(big.stitch_maps(hp, hp_big, nb, margin),
                    jbig.stitch_maps(hp, hp_big, nb, margin)):
        npt.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def small_big():
    layers = 2
    lv = perturbed_local_vars(seed=5)
    jg = jmodels.GlobalStage(num_encoder_layers=layers)
    gv = to_numpy(jg.init(jax.random.PRNGKey(6), jnp.zeros((1, 225, 38))))
    jax_mods = JaxModules(local_model=jmodels.LocalStage(), local_vars=lv,
                          global_model=jg, global_vars=gv)
    return jax_mods, bridged_modules(lv, gv, layers)


def port_estimator(mods, chunk, n_margin=N_MARGIN, block=BLOCK, big_size=BIG):
    return big.make_big_depth_estimator(
        mods, PatchConfig(), GridConfig(H=block, W=block), GridConfig(H=big_size, W=big_size),
        CamConfig(), n_margin, block_chunk=chunk, device="cpu")


def smooth_pair(size, seed):
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    disc = (yy - 0.5) ** 2 + (xx - 0.45) ** 2 < 0.06
    base = np.where(disc[..., None], r.uniform(0.1, 0.9, 3), r.uniform(0.1, 0.9, 3) * xx[..., None])
    pair = np.stack([base, base]) + r.normal(0, 0.03, (2, size, size, 3))
    return np.clip(pair, 0, 1).astype(np.float32)


def test_big_estimator_matches_jax(small_big):
    jax_mods, mods = small_big
    img = smooth_pair(BIG, 1)
    est = jbig.make_big_depth_estimator(jax_mods, JaxPatch(), JaxGrid(H=BLOCK, W=BLOCK),
                                        JaxGrid(H=BIG, W=BIG), JaxCam(), N_MARGIN)
    with jax.default_matmul_precision("highest"):
        theirs = {k: np.asarray(v) for k, v in est(jnp.asarray(img)).items()}
    ours = port_estimator(mods, 3)(img)
    assert_maps_close(ours, theirs, None)
    assert (ours["depth_final"] > 0).sum() > 0


def test_big_estimator_is_the_same_for_every_chunk(small_big):
    """block_chunk 1, 3 and 9 (one block a pass; a full chunk and a
    remainder; all four blocks in one pass) give the same maps: each block
    is the same computation whatever batch it runs in. The CNN may sum in
    another order for another batch size, so float32 noise is allowed where
    the wedge cascade amplifies it (p99.9 |diff| < 1e-4, under 0.1% of the
    entries off by more than 0.01), as tests/test_big_sharded.py allows the
    JAX package's chunks."""
    _, mods = small_big
    img = smooth_pair(SMALL_BIG, 2)
    outs = [port_estimator(mods, c, block=SMALL_BLOCK, big_size=SMALL_BIG)(img)
            for c in (1, 3, 9)]
    for out in outs[1:]:
        assert set(out) == set(outs[0])
        for k, v in outs[0].items():
            d = (out[k] - v).abs().numpy()
            assert np.quantile(d, 0.999) < 1e-4, k
            assert np.mean(d > 0.01) < 0.001, k


def test_run_eval_big_scores_and_excludes(small_big, tmp_path, monkeypatch, capsys):
    """run_eval_big over 2 pairs at 41x41 blocks over 55x55, the estimator
    wrapped to blank pair 1's depth: the printed line of pair 0 is
    eval_depth of the estimator's own map, and pair 1 is excluded and
    reported."""
    _, mods = small_big
    data = write_test_set(tmp_path / "data", 2, SMALL_BIG, 8)
    make, maps = big.make_big_depth_estimator, []

    def wrapped(*a, **k):
        est = make(*a, **k)

        def estimate(img):
            out = est(img)
            if len(maps) == 2:       # call 0 is the warm-up; call 2 is pair 1
                out["depth_final"] = torch.zeros_like(out["depth_final"])
            maps.append(out["depth_final"].numpy())
            return out
        return estimate

    monkeypatch.setattr(big, "make_big_depth_estimator", wrapped)
    args = get_args("eval", big=True, argv=[
        "--cuda", "cpu", "--img_size", str(SMALL_BLOCK), str(SMALL_BLOCK), "--big_img_size",
        str(SMALL_BIG), str(SMALL_BIG), "--n_margin_patch", str(N_MARGIN), "--data_path", str(data),
        "--block_chunk", "2"])
    res = big.run_eval_big(args, mods, device="cpu")
    out = capsys.readouterr().out
    assert "Image pair #1: no predicted pixels above threshold; excluded" in out
    assert "1/2 images had empty predictions" in out and "(over 1/2 scored images)" in out
    from blurry_edges_tpu_torch.data.datasets import TestDataset

    ds = TestDataset(str(data))
    lines = {int(m.group(1)): np.array([float(g) for g in m.groups()[1:]])
             for m in LINE.finditer(out)}
    assert sorted(lines) == [0]
    want = np.round(eval_depth(maps[1], ds[0][1][None], maps[1] > 0, crop=10), 3)
    npt.assert_allclose(lines[0], want, atol=1.5e-3)
    assert np.isfinite([res[k] for k in ("delta1", "rmse", "absrel")]).all()
    # two data-parallel devices need two ranks, which parallel.launch starts
    with pytest.raises(RuntimeError, match="2 ranks"):
        args.dp_devices = 2
        big.run_eval_big(args, mods, device="cpu")


def test_big_size_must_tile(small_big):
    _, mods = small_big
    with pytest.raises(ValueError, match="tile exactly"):
        port_estimator(mods, 1, big_size=73)


def assert_big_maps_close(ours, theirs):
    """assert_maps_close's tolerances over 36 blocks: the thresholded maps
    by their 99th percentile as there, the four continuous maps by the
    same rtol/atol on all but 0.1% of their entries (and their p99.9
    within atol). A pixel whose side of a wedge edge, or whose edge, moves
    in one of the ~121 patches that cover it moves the folded mean by up to
    its jump / 121. On this pair, on the CPU, 63 of the 1,033,707 entries
    of global_shpd (max 0.013) and 143 of the 344,569 of global_bndry (max
    0.010) lie past rtol/atol 5e-3; the 147x147 cases have none. Traced
    block by block (trace_587_pair.py): they come from 5 and 7 patches in 6 of
    the 36 blocks, and from the local CNN's float32 rounding, which both
    packages share (each lies within ~7e-3 of a float64 CNN): in 19 of
    the 294,912 local patches an angle sits at 0 = 2 pi and wraps to the
    other side (an opening angle's wrap flips its wedge between empty and
    full, and its token by 2), and elsewhere the colors amplify ~1e-3 parameter differences
    to ~2e-2 in their tokens; the global stage spreads a token's change
    over its block. Fed the same tokens, the port's global stage is JAX's
    to 3e-5, and fed the same global output its render is JAX's to 8e-4."""
    assert set(ours) == set(theirs)
    for k in theirs:
        assert tuple(ours[k].shape) == theirs[k].shape, k
    for k, atol in (("global_image", 5e-3), ("global_shpd", 5e-3), ("global_bndry", 5e-3),
                    ("global_refoc", 2e-2)):
        d = np.abs(ours[k].numpy() - theirs[k])
        far = np.mean(d > atol + 5e-3 * np.abs(theirs[k]))
        assert far < 1e-3 and np.quantile(d, 0.999) < atol, (k, far)
    for k in ("global_depth", "confidence", "depth_final"):
        assert np.quantile(np.abs(ours[k].numpy() - theirs[k]), 0.99) < 5e-3, k


@pytest.mark.slow
def test_committed_weights_587_pair():
    """One 587x587 pair, committed local stage and the big path's own global
    stage (bridged), against the JAX estimator (assert_big_maps_close)."""
    from blurry_edges_tpu.train.checkpoint import load_checkpoint

    weights = ROOT / "pretrained_weights"
    lc = load_checkpoint(str(weights / "best_run_exp_local_stage"))
    gc = load_checkpoint(str(weights / "best_run_exp_global_stage_big"))
    lv = {"params": to_numpy(lc["params"]), "batch_stats": to_numpy(lc["batch_stats"])}
    gv = {"params": to_numpy(gc["params"])}
    jax_mods = JaxModules(local_model=jmodels.LocalStage(), local_vars=lv,
                          global_model=jmodels.GlobalStage(), global_vars=gv)
    mods = bridged_modules(lv, gv, 8)
    img = smooth_pair(587, 3)
    est = jbig.make_big_depth_estimator(jax_mods, JaxPatch(), JaxGrid(), JaxGrid(H=587, W=587),
                                        JaxCam(), 10, block_chunk=2)
    with jax.default_matmul_precision("highest"):
        theirs = {k: np.asarray(v) for k, v in est(jnp.asarray(img)).items()}
    ours = big.make_big_depth_estimator(mods, PatchConfig(), GridConfig(),
                                        GridConfig(H=587, W=587), CamConfig(), 10,
                                        block_chunk=2, device="cpu")(img)
    assert_big_maps_close(ours, theirs)
