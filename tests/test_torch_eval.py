"""The port's evaluation surface against the JAX package's: ``eval_depth``,
``get_args("eval")``, ``run_eval`` (its per-image metrics, averages and
exclusion of empty images), ``load_inference_modules`` with ``.pth``
weights, the visualizer, the CLI's modes and the root export tool.

``run_eval`` runs both packages on a tiny test set written to a temporary
directory (49x49, 2 pairs, integer photon counts, random Flax weights
bridged into the port, 2 global layers). The maps agree to float32 level
except at knife-edge pixels whose wedge mask flips between erff and
torch.erf (tests/test_torch_pipeline.py), so the per-image metrics are
held to each other by the number of pixels that differ
(``test_run_eval_matches_jax``).
"""

import re
from pathlib import Path

import numpy as np
import numpy.testing as npt
import pytest
import torch

import jax
import jax.numpy as jnp

from blurry_edges_tpu import models as jmodels
from blurry_edges_tpu.config import get_args as jax_get_args
from blurry_edges_tpu.eval import pipeline as jpipe
from blurry_edges_tpu.eval.metrics import eval_depth as jax_eval_depth

import export_torch_assets as tool
from blurry_edges_tpu_torch import cli
from blurry_edges_tpu_torch.config import BLOCK_CHUNK, get_args
from blurry_edges_tpu_torch.eval import pipeline as pipe
from blurry_edges_tpu_torch.eval import visualize
from blurry_edges_tpu_torch.eval.metrics import eval_depth
from blurry_edges_tpu_torch.models.global_stage import GlobalStage
from blurry_edges_tpu_torch.models.local_stage import LocalStage
from blurry_edges_tpu_torch.utils import weights as w
from tests.test_torch_pipeline import bridged_modules, to_numpy
from tests.test_torch_serve_dtype import perturbed_local_vars

torch.set_num_threads(1)  # torch's and XLA-CPU's thread pools share this process

ROOT = Path(__file__).resolve().parent.parent
rng = np.random.default_rng(41)
H = 49
LINE = re.compile(r"Image pair #(\d+): delta1 = ?(\S+), delta2 = ?(\S+), delta3 = ?(\S+), "
                  r"RMSE = ?(\S+) cm, AbsRel = ?(\S+) cm")


def write_test_set(path: Path, n: int, size: int, seed: int) -> Path:
    """A seeded test set in the generator's layout: smooth two-tone scenes
    (a color ramp and a disc), integer photon counts under alpha, a depth
    map with a step at the disc's edge."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    alphas = r.uniform(180, 200, n).astype(np.float32)
    imgs = np.zeros((n, 2, size, size, 3), np.float32)
    depth = np.zeros((n, size, size), np.float32)
    for i in range(n):
        c = r.uniform(0.3, 0.7, 2)
        disc = (yy - c[0]) ** 2 + (xx - c[1]) ** 2 < r.uniform(0.03, 0.08)
        a, b = r.uniform(0.1, 0.9, (2, 3))
        base = np.where(disc[..., None], a, b * (0.6 + 0.4 * xx[..., None]))
        for k in range(2):
            lam = base * alphas[i] * (0.9 + 0.1 * k)
            imgs[i, k] = np.round(np.clip(r.poisson(lam) + r.normal(0, 2, lam.shape), 0,
                                          alphas[i]))
        depth[i] = np.where(disc, r.uniform(0.75, 0.9), r.uniform(1.0, 1.18))
    path.mkdir(parents=True, exist_ok=True)
    np.save(path / "images_ny.npy", imgs)
    np.save(path / "depth_maps.npy", depth)
    np.save(path / "alphas.npy", alphas)
    return path


def eval_args(data_path, densify=None, size=H, **over):
    args = get_args("eval", argv=["--cuda", "cpu", "--img_size", str(size), str(size),
                                  "--data_path", str(data_path)])
    args.densify = densify
    for k, v in over.items():
        setattr(args, k, v)
    return args


def parse(out: str) -> dict:
    return {int(m.group(1)): np.array([float(g) for g in m.groups()[1:]])
            for m in LINE.finditer(out)}


@pytest.mark.parametrize("crop", [0, 10])
def test_eval_depth_matches_jax(crop):
    pred = rng.uniform(0.6, 1.3, (2, 49, 49)).astype(np.float32)
    gt = rng.uniform(0.75, 1.18, (2, 49, 49)).astype(np.float32)
    msk = rng.uniform(size=(2, 49, 49)) < 0.6
    npt.assert_array_equal(eval_depth(pred, gt, msk, crop=crop),
                           jax_eval_depth(pred, gt, msk, crop=crop))


@pytest.mark.parametrize("big", [False, True])
def test_get_args_eval_matches_jax(big):
    """The JAX package's flags and defaults, but --cuda's help and
    --block_chunk's default (the H100 sweep's, not the TPU's)."""
    ours = vars(get_args("eval", big=big, argv=[]))
    theirs = vars(jax_get_args("eval", big=big, argv=[]))
    assert set(ours) == set(theirs)
    if big:
        assert ours.pop("block_chunk") == BLOCK_CHUNK
        theirs.pop("block_chunk")
    assert ours == theirs
    argv = ["--densify", "w", "--serve_dtype", "bfloat16", "--crop", "5", "--vis_max", "2"]
    assert vars(get_args("eval", big=big, argv=argv)).items() >= {
        "densify": "w", "serve_dtype": "bfloat16", "crop": 5, "vis_max": 2}.items()


@pytest.fixture(scope="module")
def tiny_eval(tmp_path_factory):
    """Bridged random weights (2 global layers) in both packages and a
    2-pair test set."""
    layers = 2
    lv = perturbed_local_vars(seed=3)
    jg = jmodels.GlobalStage(num_encoder_layers=layers)
    gv = to_numpy(jg.init(jax.random.PRNGKey(4), jnp.zeros((1, 225, 38))))
    jax_mods = jpipe.InferenceModules(local_model=jmodels.LocalStage(), local_vars=lv,
                                      global_model=jg, global_vars=gv)
    data = write_test_set(tmp_path_factory.mktemp("tiny") / "data", 2, H, 5)
    return jax_mods, bridged_modules(lv, gv, layers), data


def capturing(module, monkeypatch, store):
    """Wrap ``module.make_depth_estimator`` so that every map it returns is
    kept (as numpy) in ``store``."""
    make = module.make_depth_estimator

    def wrapped(*a, **k):
        est = make(*a, **k)

        def estimate(img):
            out = est(img)
            store.append(np.asarray(out["depth_final"]))
            return out
        return estimate

    monkeypatch.setattr(module, "make_depth_estimator", wrapped)


@pytest.mark.parametrize("densify", [None, "w"])
def test_run_eval_matches_jax(tiny_eval, densify, capsys, monkeypatch):
    """Each loop prints eval_depth of its own maps, and the two loops score
    the same images. The maps agree but for knife-edge pixels (mask flips,
    at most 1% of the cropped area); where a pair's maps agree, its metrics
    agree to the prints' 3 decimals, and where k pixels differ out of n
    predicted, its deltas agree within k / n (with densify none at this
    size, n is ~20 and one flipped pixel moves a delta by ~0.05)."""
    jax_mods, mods, data = tiny_eval
    args = eval_args(data, densify)
    maps = {"jax": [], "port": []}
    capturing(jpipe, monkeypatch, maps["jax"])
    capturing(pipe, monkeypatch, maps["port"])
    with jax.default_matmul_precision("highest"):
        theirs = jpipe.run_eval(args, jax_mods)
    out_theirs = capsys.readouterr().out
    ours = pipe.run_eval(args, mods, device="cpu")
    out_ours = capsys.readouterr().out
    per = {"jax": parse(out_theirs), "port": parse(out_ours)}
    assert sorted(per["port"]) == sorted(per["jax"]) and per["port"]   # the same scored images
    assert ("excluded" in out_ours) == ("excluded" in out_theirs)

    from blurry_edges_tpu_torch.data.datasets import TestDataset

    ds, c = TestDataset(str(data)), args.crop
    for j in range(len(ds)):
        gt = ds[j][1]
        for side in maps:        # map 0 is the warm-up call's
            depth = maps[side][j + 1]
            if j in per[side]:
                want = np.round(eval_depth(depth, gt[None], depth > 0, crop=c), 3)
                npt.assert_allclose(per[side][j], want, atol=1.5e-3, err_msg=f"{side} pair {j}")
        a, b = (maps[side][j + 1][0, c:-c, c:-c] for side in ("jax", "port"))
        k = int(((a > 0) != (b > 0)).sum() + ((a > 0) & (b > 0) & (np.abs(a - b) > 1e-3)).sum())
        assert k <= 0.01 * a.size, (j, k)
        if j in per["jax"]:
            n = min((a > 0).sum(), (b > 0).sum())
            tol = 1.5e-3 + k / n
            npt.assert_allclose(per["port"][j][:3], per["jax"][j][:3], atol=tol, err_msg=f"{j}")
            if k == 0:
                npt.assert_allclose(per["port"][j][3:], per["jax"][j][3:], atol=1.5e-3)
    assert set(ours) == set(theirs)
    assert ours["pairs_per_sec"] > 0 and ours["avg_time"] > 0
    assert "Average metrics for whole dataset" in out_ours


def test_run_eval_excludes_empty_predictions(monkeypatch, capsys, tmp_path):
    """An image with no predicted pixel is excluded from the averages and
    reported, as the JAX package does (tests/test_eval_empty_guard.py)."""
    calls = {"n": 0}

    def fake_make(mods, patch_cfg, grid, cam, densify=None, rho_prime=10.39, device="cuda"):
        def estimate(img):
            j = calls["n"]
            calls["n"] += 1
            depth = torch.zeros((1, 147, 147))
            if j != 1:  # pair 0 of the loop (call 0 is the warm-up on pair 0)
                depth[0, 50:60, 50:60] = 0.9
            return {"depth_final": depth}
        return estimate

    monkeypatch.setattr(pipe, "make_depth_estimator", fake_make)
    data = tmp_path / "data"
    data.mkdir()
    np.save(data / "images_ny.npy", np.zeros((3, 2, 147, 147, 3), np.uint8))
    np.save(data / "depth_maps.npy", np.full((3, 147, 147), 0.9, np.float32))
    np.save(data / "alphas.npy", np.full(3, 190.0, np.float32))
    res = pipe.run_eval(eval_args(data, size=147), modules=None, device="cpu")
    out = capsys.readouterr().out
    assert "Image pair #0: no predicted pixels above threshold; excluded" in out
    assert "1/3 images had empty predictions" in out
    assert "(over 2/3 scored images)" in out
    assert np.isfinite([res["delta1"], res["rmse"], res["absrel"]]).all()
    assert res["delta1"] == pytest.approx(1.0)


def test_dp_devices_is_not_ported(tmp_path):
    """--dp_devices 2 outside a rank: run_eval does not fall back to one
    device; the ranks are processes (the CLI starts them, parallel.launch)."""
    args = eval_args(tmp_path, dp_devices=2)
    with pytest.raises(RuntimeError, match="2 ranks"):
        pipe.run_eval(args, modules=None, device="cpu")


def test_loader_resolves_names_in_jax_order(tmp_path, capsys):
    """Per stage the first name found as .pth, in the JAX package's order;
    the choice is printed; a name present only as an Orbax directory
    raises, naming the export tool; no random fallback unless asked."""
    assert w.global_names() == ("pretrained_global_stage", "best_run_exp_global_stage")
    assert w.global_names("w")[:2] == ("pretrained_global_stage_w", "best_run_exp_global_stage_w")
    assert w.global_names(big=True)[:2] == ("pretrained_global_stage_big",
                                            "best_run_exp_global_stage_big")
    g = torch.Generator().manual_seed(0)
    sds = {}
    for name, cls in (("best_run_exp_local_stage", LocalStage),
                      ("pretrained_global_stage", GlobalStage),
                      ("best_run_exp_global_stage", GlobalStage),
                      ("best_run_exp_global_stage_big", GlobalStage)):
        m = cls()
        w._randomize(m, g)
        sds[name] = m.state_dict()
        torch.save(sds[name], tmp_path / f"{name}.pth")
    args = eval_args(tmp_path, model_path=str(tmp_path))
    mods = w.load_inference_modules(args, device="cpu")
    out = capsys.readouterr().out
    assert f"local stage <- {tmp_path}/best_run_exp_local_stage.pth" in out
    # the reference name outranks the committed one
    assert f"global stage <- {tmp_path}/pretrained_global_stage.pth" in out
    for k, v in mods.global_model.state_dict().items():
        assert torch.equal(v, sds["pretrained_global_stage"][k]), k
    # big: its own stage first
    w.load_inference_modules(args, big=True, device="cpu")
    assert f"global stage <- {tmp_path}/best_run_exp_global_stage_big.pth" in capsys.readouterr().out
    # w: no w-variant file, so the shared stage
    w.load_inference_modules(args, densify="w", device="cpu")
    assert "pretrained_global_stage.pth" in capsys.readouterr().out
    # pp: no U-Net anywhere
    with pytest.raises(FileNotFoundError, match="pretrained_depth_completion_pp"):
        w.load_inference_modules(args, densify="pp", device="cpu")
    mods = w.load_inference_modules(args, densify="pp", allow_random=True, device="cpu")
    assert mods.unet_model is not None and "seeded random" in capsys.readouterr().out
    # an Orbax-only name raises
    (tmp_path / "pretrained_depth_completion_pp").mkdir()
    with pytest.raises(FileNotFoundError, match="export_torch_assets.py"):
        w.load_inference_modules(args, densify="pp", allow_random=True, device="cpu")
    # serve dtype
    args.serve_dtype = "bfloat16"
    mods = w.load_inference_modules(args, device="cpu")
    assert mods.local_model.conv1[0].compute_dtype == torch.bfloat16
    assert mods.global_model.compute_dtype == torch.bfloat16
    assert mods.local_model.conv1[0].weight.dtype == torch.float32
    if not torch.cuda.is_available():     # the entry point defaults to the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            w.load_inference_modules(args)


def test_exported_weights_load_as_the_bridge_maps_them(tmp_path):
    """The export tool writes a committed checkpoint's bridged state dict;
    the loader reads it back into the same tensors."""
    from blurry_edges_tpu.train.checkpoint import load_checkpoint

    name = "best_run_exp_global_stage_big"
    tool.export_weights(str(ROOT / "pretrained_weights"), str(tmp_path), [name])
    want = w.jax_global_to_torch(to_numpy(load_checkpoint(
        str(ROOT / "pretrained_weights" / name))["params"]))
    args = eval_args(tmp_path, model_path=str(tmp_path))
    with pytest.raises(FileNotFoundError, match="local_stage"):
        w.load_inference_modules(args, big=True, device="cpu")
    args.model_path = str(tmp_path)
    torch.save(LocalStage().state_dict(), tmp_path / "best_run_exp_local_stage.pth")
    got = w.load_inference_modules(args, big=True, device="cpu").global_model.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_export_test_set_round_trip(tmp_path):
    """uint8 images load back to the same float32 counts; non-integer or
    out-of-range counts are refused."""
    src = write_test_set(tmp_path / "src", 3, 23, 9)
    assert tool.export_test_set(str(src), str(tmp_path / "out"), 1, 3) == 2
    imgs = np.load(tmp_path / "out" / "images_ny.npy")
    assert imgs.dtype == np.uint8
    from blurry_edges_tpu_torch.data.datasets import TestDataset

    a, b = TestDataset(str(tmp_path / "out")), TestDataset(str(src))
    assert len(a) == 2
    for j in range(2):
        for x, y in zip(a[j], b[j + 1]):
            assert x.dtype == np.float32 and np.array_equal(x, y)
    with pytest.raises(ValueError, match="not integers"):
        tool.counts_to_uint8(np.array([1.0, 2.5], np.float32))
    with pytest.raises(ValueError, match="not integers"):
        tool.counts_to_uint8(np.array([1.0, 256.0], np.float32))


def test_visualizer_writes_a_canvas_or_is_absent_without_cv2(tmp_path, monkeypatch):
    args = eval_args(tmp_path, size=21, log_path=str(tmp_path / "logs"), vis_max=1)
    out = {"global_image": np.full((1, 2, 21, 21, 3), 0.5, np.float32),
           "global_shpd": np.full((1, 21, 21, 3), 0.5, np.float32),
           "global_refoc": np.full((1, 21, 21, 3), 0.5, np.float32),
           "confidence": np.full((1, 21, 21), 0.2, np.float32),
           "global_bndry": np.zeros((1, 21, 21), np.float32),
           "depth_final": np.full((1, 21, 21), 0.9, np.float32)}
    if visualize.HAS_CV2:
        cb = visualize.make_file_visualizer(args)
        cb(0, np.zeros((2, 21, 21, 3), np.float32), np.full((21, 21), 0.9, np.float32), out)
        cb(1, np.zeros((2, 21, 21, 3), np.float32), np.full((21, 21), 0.9, np.float32), out)
        assert sorted(p.name for p in (tmp_path / "logs" / "visualizations").iterdir()) == ["0.png"]
    monkeypatch.setattr(visualize, "HAS_CV2", False)
    assert visualize.make_file_visualizer(args) is None


def test_cli_picks_the_mode(monkeypatch):
    seen = []
    for name in ("eval", "eval_big", "global_train"):
        monkeypatch.setitem(cli.MODES, name, lambda argv, name=name: seen.append((name, argv)))
    monkeypatch.setattr(cli, "global_train_main", lambda argv: seen.append(("flags", argv)))
    cli.main(["eval", "--densify", "w"])
    cli.main(["eval_big", "--block_chunk", "2"])
    cli.main(["--attn_impl", "flash"])
    assert seen == [("eval", ["--densify", "w"]), ("eval_big", ["--block_chunk", "2"]),
                    ("flags", ["--attn_impl", "flash"])]
    with pytest.raises(SystemExit, match="unknown mode"):
        cli.main(["train_local"])


def test_cli_eval_runs_on_the_cpu(tmp_path, capsys):
    """eval end to end through the CLI on the CPU, from .pth weights, with
    --profile writing a torch.profiler trace."""
    g = torch.Generator().manual_seed(1)
    for name, cls in (("best_run_exp_local_stage", LocalStage),
                      ("best_run_exp_global_stage", GlobalStage)):
        m = cls()
        w._randomize(m, g)
        torch.save(m.state_dict(), tmp_path / f"{name}.pth")
    data = write_test_set(tmp_path / "data", 2, 41, 6)
    res = cli.eval_main(["--cuda", "cpu", "--img_size", "41", "41", "--data_path", str(data),
                         "--model_path", str(tmp_path), "--densify", "w",
                         "--log_path", str(tmp_path / "logs"), "--vis_max", "1", "--profile"])
    out = capsys.readouterr().out
    assert "Average metrics for whole dataset" in out and "Image pair #1" in out
    assert np.isfinite(res["delta1"])
    assert (tmp_path / "logs" / "trace" / "trace.json").stat().st_size > 0   # --profile
