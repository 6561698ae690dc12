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
pixel between 0 and a metric depth).
"""

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
from blurry_edges_tpu_torch.utils.weights import (jax_global_to_torch,
                                                  jax_local_to_torch,
                                                  random_modules)

torch.set_num_threads(1)  # torch's and XLA-CPU's thread pools share this process

ROOT = Path(__file__).resolve().parent.parent
H = 41
rng = np.random.default_rng(8)


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def bridged_modules(local_vars, global_vars, layers):
    local = LocalStage()
    local.load_state_dict(jax_local_to_torch(local_vars["params"], local_vars["batch_stats"]))
    glob = GlobalStage(num_encoder_layers=layers)
    glob.load_state_dict(jax_global_to_torch(global_vars["params"]))
    return InferenceModules(local_model=local.eval(), global_model=glob.eval())


def assert_maps_close(ours, theirs, densify):
    assert set(ours) == set(theirs)
    for k in theirs:
        assert tuple(ours[k].shape) == theirs[k].shape, k
    for k in ("global_image", "global_shpd", "global_bndry"):
        npt.assert_allclose(ours[k].numpy(), theirs[k], rtol=5e-3, atol=5e-3, err_msg=k)
    npt.assert_allclose(ours["global_refoc"].numpy(), theirs["global_refoc"],
                        rtol=5e-3, atol=2e-2)
    for k in ("global_depth", "confidence", "depth_final"):
        d = np.abs(ours[k].numpy() - theirs[k])
        assert np.quantile(d, 0.99) < 5e-3, (densify, k, np.quantile(d, 0.99))


@pytest.fixture(scope="module")
def small_slice():
    """Random Flax weights (BatchNorm statistics perturbed), bridged."""
    layers = 2
    key = jax.random.PRNGKey(0)
    grid = JaxGrid(H=H, W=H)
    jl, jg = jmodels.LocalStage(), jmodels.GlobalStage(num_encoder_layers=layers)
    lv = to_numpy(jl.init(key, jnp.zeros((1, 21, 21, 3))))
    lv["batch_stats"] = jax.tree.map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), lv["batch_stats"])
    gv = to_numpy(jg.init(key, jnp.zeros((1, grid.num_tokens, 38))))
    jax_mods = JaxModules(local_model=jl, local_vars=lv, global_model=jg, global_vars=gv)
    return jax_mods, bridged_modules(lv, gv, layers)


@pytest.mark.parametrize("densify", [None, "w"])
def test_slice_matches_jax_estimator(small_slice, densify):
    jax_mods, mods = small_slice
    img = rng.uniform(0, 1, size=(2, H, H, 3)).astype(np.float32)
    est = jax_estimator(jax_mods, JaxPatch(), JaxGrid(H=H, W=H), JaxCam(), densify=densify)
    with jax.default_matmul_precision("highest"):
        theirs = {k: np.asarray(v) for k, v in est(jnp.asarray(img)).items()}
    ours = make_depth_estimator(mods, PatchConfig(), GridConfig(H=H, W=H), CamConfig(),
                                densify=densify, device="cpu")(img)
    assert_maps_close(ours, theirs, densify)


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
    """An estimator turns TF32 off for its models whatever the caller set
    (PyTorch leaves it on for cuDNN convolutions), and gives the caller's
    settings back afterwards."""
    mods = random_modules(torch.Generator().manual_seed(2), device="cpu")
    seen = []

    def record(mod, args):
        seen.append((type(mod).__name__, torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))

    handles = [m.register_forward_pre_hook(record)
               for m in (mods.local_model, mods.global_model)]
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        imgs = rng.uniform(0, 1, size=(2, H, H, 3)).astype(np.float32)
        if make is make_batched_depth_estimator:
            imgs = imgs[None]
        make(mods, PatchConfig(), GridConfig(H=H, W=H), CamConfig(), device="cpu")(imgs)
        after = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
        for h in handles:
            h.remove()
    assert seen == [("LocalStage", False, False), ("GlobalStage", False, False)]
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
                             densify="pp", device="cpu")


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


@pytest.mark.slow
@pytest.mark.parametrize("densify", [None, "w"])
def test_full_slice_committed_weights(densify):
    """147x147 with the committed checkpoints (the w variant's own global
    stage for densify w), against the JAX estimator."""
    from blurry_edges_tpu.train.checkpoint import load_checkpoint

    weights = ROOT / "pretrained_weights"
    lc = load_checkpoint(str(weights / "best_run_exp_local_stage"))
    gname = "best_run_exp_global_stage_w" if densify == "w" else "best_run_exp_global_stage"
    gc = load_checkpoint(str(weights / gname))
    lv = {"params": to_numpy(lc["params"]), "batch_stats": to_numpy(lc["batch_stats"])}
    gv = {"params": to_numpy(gc["params"])}
    jax_mods = JaxModules(local_model=jmodels.LocalStage(), local_vars=lv,
                          global_model=jmodels.GlobalStage(), global_vars=gv)
    mods = bridged_modules(lv, gv, 8)
    img = rng.uniform(0, 1, size=(2, 147, 147, 3)).astype(np.float32)
    est = jax_estimator(jax_mods, JaxPatch(), JaxGrid(), JaxCam(), densify=densify)
    with jax.default_matmul_precision("highest"):
        theirs = {k: np.asarray(v) for k, v in est(jnp.asarray(img)).items()}
    ours = make_depth_estimator(mods, PatchConfig(), GridConfig(), CamConfig(),
                                densify=densify, device="cpu")(img)
    assert_maps_close(ours, theirs, densify)
