"""The port's 147x147 serving slice against the JAX package's
``make_depth_estimator``, its entry points' device rule, and its
independence from JAX.

The slice test runs a reduced grid (41x41, 121 tokens) through both
packages with the same random Flax weights bridged into the port, at full
model width and 2 global layers; the full 147x147 grid with the committed
checkpoints is in the slow tier. Tolerances are those tests/test_pipeline.py
holds the JAX pipeline to against the torch reference: the continuous maps
rtol/atol 5e-3, and the thresholded depth/confidence maps by their 99th
percentile |diff| < 5e-3 (a float-level difference can flip a borderline
pixel between 0 and a metric depth). The ``pp`` densify's depth_final, the
U-Net over global_depth, has its own check (``assert_pp_depth_close``).
"""

import ast
import os
import re
import subprocess
import sys
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
from blurry_edges_tpu.eval.pipeline import (InferenceModules as JaxModules,
                                            make_depth_estimator as jax_estimator)

from blurry_edges_tpu_torch.config import CamConfig, GridConfig, PatchConfig
from blurry_edges_tpu_torch.eval.pipeline import (InferenceModules,
                                                  make_batched_depth_estimator,
                                                  make_depth_estimator)
from blurry_edges_tpu_torch.models.global_stage import GlobalStage
from blurry_edges_tpu_torch.models.local_stage import LocalStage
from blurry_edges_tpu_torch.models.weights import (jax_global_to_torch,
                                                  jax_local_to_torch,
                                                  random_modules)
from tests.test_torch_unet import bridged_unet, perturbed_unet_vars

torch.set_num_threads(1)  # torch's and XLA-CPU's thread pools share this process

ROOT = Path(__file__).resolve().parent.parent
H = 41
rng = np.random.default_rng(8)


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def bridged_modules(local_vars, global_vars, layers, unet_vars=None):
    local = LocalStage()
    local.load_state_dict(jax_local_to_torch(local_vars["params"], local_vars["batch_stats"]))
    glob = GlobalStage(num_encoder_layers=layers)
    glob.load_state_dict(jax_global_to_torch(global_vars["params"]))
    unet = None if unet_vars is None else bridged_unet(unet_vars)
    return InferenceModules(local_model=local.eval(), global_model=glob.eval(), unet_model=unet)


def assert_maps_close(ours, theirs, densify):
    assert set(ours) == set(theirs)
    for k in theirs:
        assert tuple(ours[k].shape) == theirs[k].shape, k
    for k in ("global_image", "global_shpd", "global_bndry"):
        npt.assert_allclose(ours[k].numpy(), theirs[k], rtol=5e-3, atol=5e-3, err_msg=k)
    npt.assert_allclose(ours["global_refoc"].numpy(), theirs["global_refoc"],
                        rtol=5e-3, atol=2e-2)
    thresholded = ("global_depth", "confidence") + (() if densify == "pp" else ("depth_final",))
    for k in thresholded:
        d = np.abs(ours[k].numpy() - theirs[k])
        assert np.quantile(d, 0.99) < 5e-3, (densify, k, np.quantile(d, 0.99))


def assert_pp_depth_close(ours, theirs, unet):
    """densify pp: depth_final is the U-Net over the folded global_depth. A
    knife-edge pixel of global_depth (its wedge mask flipped between erff
    and torch.erf: a jump between 0 and a metric depth, which the 99%
    quantile above allows) spreads over the U-Net's receptive field; at
    41x41, one such pixel of 1,681 put depth_final's p99 |diff| at 2-4e-2
    of a 0.7-0.8 scale. So the U-Net is held exactly where the inputs are
    the same: the port's U-Net fed JAX's global_depth gives JAX's
    depth_final to rtol 1e-4, atol 1e-4 x max|depth_final| (the whole
    difference comes in through global_depth); end to end, the bulk agrees
    (p90 |diff| < 5e-3) and no pixel is off by more than 0.25 x scale."""
    want = theirs["depth_final"]
    scale = np.abs(want).max()
    with torch.no_grad():
        fed = unet(torch.tensor(theirs["global_depth"])[:, None])[:, 0].numpy()
    npt.assert_allclose(fed, want, rtol=1e-4, atol=1e-4 * scale)
    d = np.abs(ours["depth_final"].numpy() - want)
    assert np.quantile(d, 0.9) < 5e-3, np.quantile(d, 0.9)
    assert d.max() < 0.25 * scale, (d.max(), scale)


@pytest.fixture(scope="module")
def small_slice():
    """Random Flax weights (BatchNorm statistics perturbed), bridged; the
    U-Net's as tests/test_torch_unet.py draws them."""
    layers = 2
    key = jax.random.PRNGKey(0)
    grid = JaxGrid(H=H, W=H)
    jl, jg = jmodels.LocalStage(), jmodels.GlobalStage(num_encoder_layers=layers)
    lv = to_numpy(jl.init(key, jnp.zeros((1, 21, 21, 3))))
    lv["batch_stats"] = jax.tree.map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), lv["batch_stats"])
    gv = to_numpy(jg.init(key, jnp.zeros((1, grid.num_tokens, 38))))
    uv = perturbed_unet_vars()
    jax_mods = JaxModules(local_model=jl, local_vars=lv, global_model=jg, global_vars=gv,
                          unet_model=jmodels.UNet(), unet_vars=uv)
    return jax_mods, bridged_modules(lv, gv, layers, uv)


@pytest.mark.parametrize("densify", [None, "w", "pp"])
def test_slice_matches_jax_estimator(small_slice, densify):
    jax_mods, mods = small_slice
    img = rng.uniform(0, 1, size=(2, H, H, 3)).astype(np.float32)
    est = jax_estimator(jax_mods, JaxPatch(), JaxGrid(H=H, W=H), JaxCam(), densify=densify)
    with jax.default_matmul_precision("highest"):
        theirs = {k: np.asarray(v) for k, v in est(jnp.asarray(img)).items()}
    ours = make_depth_estimator(mods, PatchConfig(), GridConfig(H=H, W=H), CamConfig(),
                                densify=densify, device="cpu")(img)
    assert_maps_close(ours, theirs, densify)
    if densify == "pp":
        assert_pp_depth_close(ours, theirs, mods.unet_model)


def test_batched_matches_single():
    mods = random_modules(torch.Generator().manual_seed(1), device="cpu")
    grid = GridConfig(H=H, W=H)
    imgs = rng.uniform(0, 1, size=(3, 2, H, H, 3)).astype(np.float32)
    single = make_depth_estimator(mods, PatchConfig(), grid, CamConfig(), device="cpu")
    batched = make_batched_depth_estimator(mods, PatchConfig(), grid, CamConfig(),
                                           device="cpu")(imgs)
    for i in range(3):
        out = single(imgs[i])
        for k, v in out.items():
            assert batched[k].shape == (3,) + tuple(v.shape), k
            # one pass over the batch may reorder the CNN's sums; the wedge
            # cascade amplifies that at thresholds: bound the bulk and flips
            d = (batched[k][i] - v).abs().numpy()
            assert np.quantile(d, 0.8) < 1e-3, k
            assert np.mean(d > 0.01) < 0.05, k


@pytest.mark.parametrize("make", [make_depth_estimator, make_batched_depth_estimator])
def test_estimators_run_in_float32(make):
    """An estimator turns TF32 off for its models (the U-Net's too, densify
    pp) whatever the caller set
    (PyTorch leaves it on for cuDNN convolutions), and gives the caller's
    settings back afterwards."""
    mods = random_modules(torch.Generator().manual_seed(2), device="cpu", unet=True)
    seen = []

    def record(mod, args):
        seen.append((type(mod).__name__, torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))

    handles = [m.register_forward_pre_hook(record)
               for m in (mods.local_model, mods.global_model, mods.unet_model)]
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        imgs = rng.uniform(0, 1, size=(2, H, H, 3)).astype(np.float32)
        if make is make_batched_depth_estimator:
            imgs = imgs[None]
        make(mods, PatchConfig(), GridConfig(H=H, W=H), CamConfig(), densify="pp",
             device="cpu")(imgs)
        after = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
        for h in handles:
            h.remove()
    assert seen == [("LocalStage", False, False), ("GlobalStage", False, False),
                    ("UNet", False, False)]
    assert after == (True, True)


def test_entry_points_default_to_cuda():
    """Left at device="cuda" on a host without a GPU, the entry points raise
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    cpu_mods = random_modules(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        random_modules(torch.Generator().manual_seed(0))
    for make in (make_depth_estimator, make_batched_depth_estimator):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(cpu_mods, PatchConfig(), GridConfig(), CamConfig())
    with pytest.raises(ValueError, match="densify"):
        make_depth_estimator(cpu_mods, PatchConfig(), GridConfig(), CamConfig(),
                             densify="bogus", device="cpu")


@pytest.mark.parametrize("make", [make_depth_estimator, make_batched_depth_estimator])
def test_pp_needs_a_unet(make):
    """densify pp without a U-Net in the modules is refused when the
    estimator is built, not at its first call."""
    mods = random_modules(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="unet_model"):
        make(mods, PatchConfig(), GridConfig(H=H, W=H), CamConfig(), densify="pp", device="cpu")


def test_batched_pp_matches_single():
    """The batched estimator runs the U-Net once over (B, 1, H, W); in eval
    mode that is B single-pair passes (the JAX package vmaps one)."""
    mods = random_modules(torch.Generator().manual_seed(3), device="cpu", unet=True)
    grid = GridConfig(H=H, W=H)
    imgs = rng.uniform(0, 1, size=(2, 2, H, H, 3)).astype(np.float32)
    batched = make_batched_depth_estimator(mods, PatchConfig(), grid, CamConfig(),
                                           densify="pp", device="cpu")(imgs)
    single = make_depth_estimator(mods, PatchConfig(), grid, CamConfig(), densify="pp",
                                  device="cpu")
    for i in range(2):
        out = single(imgs[i])
        # the U-Net alone on the batched global depth, one pair at a time
        with torch.no_grad():
            alone = mods.unet_model(batched["global_depth"][i][:, None])
        torch.testing.assert_close(batched["depth_final"][i], alone[:, 0], rtol=1e-5, atol=1e-6)
        d = (batched["depth_final"][i] - out["depth_final"]).abs().numpy()
        assert np.quantile(d, 0.8) < 1e-3 and np.mean(d > 0.01) < 0.05


FORBIDDEN = ("jax", "flax", "optax", "orbax", "blurry_edges_tpu")


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, import with JAX, Flax,
    Optax, Orbax and the JAX package made unimportable; and no source line
    imports them, not even inside a function."""
    pattern = re.compile(r"^\s*(import|from)\s+(%s)\b" % "|".join(FORBIDDEN), re.M)
    sources = sorted((ROOT / "blurry_edges_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for path in sources:
        assert not pattern.search(path.read_text()), path
    code = (
        "import importlib, importlib.util, pkgutil, sys\n"
        f"for name in {FORBIDDEN!r}:\n"
        "    sys.modules[name] = None\n"
        "import blurry_edges_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', 'chip_smoke.py')\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "assert callable(mod.main)\n"
        "print(len(names))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 18  # every module was imported


# The port's layers, bottom to top. A module imports from its own layer or a
# lower one, lazy imports inside functions included.
LAYERS = (("config", "utils"), ("parallel",), ("ops",), ("models",), ("data",),
          ("eval",), ("train",), ("cli",))


def test_port_imports_point_down_the_layers():
    """No module of the port imports from a higher layer than its own, and
    every module belongs to a layer; each offending import is named in the
    one failure message."""
    rank = {name: i for i, names in enumerate(LAYERS) for name in names}
    faults = []
    for path in sorted((ROOT / "blurry_edges_tpu_torch").rglob("*.py")):
        parts = path.relative_to(ROOT).with_suffix("").parts
        if parts[1:] == ("__init__",):
            continue
        where = path.relative_to(ROOT)
        if parts[1] not in rank:
            faults.append(f"{where}: {parts[1]} is in no layer")
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                targets = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom):
                base = list(parts[:len(parts) - node.level]) if node.level else []
                base += node.module.split(".") if node.module else []
                targets = [".".join(base + [alias.name]) for alias in node.names]
            else:
                continue
            for target in targets:
                top = target.split(".")
                if (top[0] == "blurry_edges_tpu_torch" and len(top) > 1
                        and rank.get(top[1], -1) > rank[parts[1]]):
                    faults.append(f"{where}:{node.lineno}: {parts[1]} imports {target}")
    assert not faults, "imports against the layer order:\n" + "\n".join(faults)


@pytest.mark.slow
@pytest.mark.parametrize("densify", [None, "w", "pp"])
def test_full_slice_committed_weights(densify):
    """147x147 with the committed checkpoints (the w variant's own global
    stage for densify w, the committed U-Net for densify pp), against the
    JAX estimator."""
    from blurry_edges_tpu.train.checkpoint import load_checkpoint

    weights = ROOT / "pretrained_weights"
    lc = load_checkpoint(str(weights / "best_run_exp_local_stage"))
    gname = "best_run_exp_global_stage_w" if densify == "w" else "best_run_exp_global_stage"
    gc = load_checkpoint(str(weights / gname))
    lv = {"params": to_numpy(lc["params"]), "batch_stats": to_numpy(lc["batch_stats"])}
    gv = {"params": to_numpy(gc["params"])}
    uv = None
    if densify == "pp":
        uc = load_checkpoint(str(weights / "best_run_exp_depth_completion_pp"))
        uv = {"params": to_numpy(uc["params"]), "batch_stats": to_numpy(uc["batch_stats"])}
    jax_mods = JaxModules(local_model=jmodels.LocalStage(), local_vars=lv,
                          global_model=jmodels.GlobalStage(), global_vars=gv,
                          unet_model=None if uv is None else jmodels.UNet(), unet_vars=uv)
    mods = bridged_modules(lv, gv, 8, uv)
    img = rng.uniform(0, 1, size=(2, 147, 147, 3)).astype(np.float32)
    est = jax_estimator(jax_mods, JaxPatch(), JaxGrid(), JaxCam(), densify=densify)
    with jax.default_matmul_precision("highest"):
        theirs = {k: np.asarray(v) for k, v in est(jnp.asarray(img)).items()}
    ours = make_depth_estimator(mods, PatchConfig(), GridConfig(), CamConfig(),
                                densify=densify, device="cpu")(img)
    assert_maps_close(ours, theirs, densify)
    if densify == "pp":
        assert_pp_depth_close(ours, theirs, mods.unet_model)
