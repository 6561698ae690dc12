"""The port's data parallelism (``--dp_devices``, ``parallel/mesh.py``)
against the port in one process, on the CPU: world size 2 under gloo.

Two ranks are spawned once for the module (``rank_job``) and run, on seeded
numpy data written to a temporary directory:

- one train-mode step of a BatchNorm layer on each rank's share of a
  global batch: the normalised output and the running statistics equal
  one process's on the whole batch to 1e-6, the parameters' gradients
  (summed over the ranks) to 1e-6 of their largest;
- ``local_train`` through the CLI (``--dp_devices 2`` inside a rank) and
  ``run_global_training`` (its defaults: batch 4 in chunks of 2, one a
  rank, drawing the dropout masks one process draws): their validation
  curves agree with one process's to rtol 2e-3 / atol 1e-5, the JAX
  package's own limit in ``tests/test_dp_harness.py``;
- ``run_eval`` over 3 pairs (a group of 2, then a padded group): the
  per-pair metrics and averages equal one process's, the pairs printed in
  order, the pad not scored; ``run_eval_big`` at 41x41 blocks over 55x55
  (4 blocks, 2 a rank): the maps equal one process's bit for bit (one
  block a chunk on both sides, so each block computes alike) and so do its
  metrics.

The CLI's own launch (``eval --dp_devices 2 --cuda cpu`` from this process)
is checked once more against one process, and passes the launch no
wall-clock limit. This file imports no JAX: the
spawned ranks import it to find their function, and torch's and XLA-CPU's
thread pools deadlock in one process. Each rank sets one thread, and each
launch is joined with a timeout of its own.
"""

import contextlib
import io
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from blurry_edges_tpu_torch import cli
from blurry_edges_tpu_torch.config import get_args
from blurry_edges_tpu_torch.eval import pipeline, pipeline_big
from blurry_edges_tpu_torch.models.batchnorm import BatchNorm2d
from blurry_edges_tpu_torch.parallel import mesh as pm
from blurry_edges_tpu_torch.train.global_ import run_global_training
from blurry_edges_tpu_torch.utils.weights import random_modules

torch.set_num_threads(1)

R = 21
H = 41                           # the 147x147 paths' images, cut to 41x41
BLOCK, BIG, MARGIN = 41, 55, 2   # the 587x587 path cut to 2x2 blocks
TIMEOUT = 120                    # seconds a launch may take


def write_local_set(root: Path, n_train=16, n_val=8, seed=0):
    """A patch set in ShapeDataset(mode='local')'s layout."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:R, 0:R].astype(np.float32) / R
    root.mkdir(parents=True)
    for part, n in (("train", n_train), ("val", n_val)):
        a = rng.uniform(180, 200, n).astype(np.float32)
        gt = []
        for _ in range(n):
            s, c1, c2 = rng.uniform(-1, 1), rng.uniform(0, 1, 3), rng.uniform(0, 1, 3)
            gt.append(np.where(((yy - 0.5) > s * (xx - 0.5))[..., None], c1, c2))
        gt = np.stack(gt).astype(np.float32) * a[:, None, None, None]
        ny = np.clip(np.round(gt + rng.normal(0, 3, gt.shape)), 0, 255).astype(np.float32)
        arrays = dict(patches_ny=ny, patches_gt=gt, alphas=a,
                      boundary_distances=rng.integers(0, 12, (n, R, R)).astype(np.float32),
                      derivative_maps=rng.uniform(0, 2, (n, R, R, 3)).astype(np.float32))
        for name, arr in arrays.items():
            np.save(root / f"{name}_{part}.npy", arr)


def write_global_set(root: Path, n_train=8, n_val=4, seed=1):
    """A set in load_global_compact's layout (images as integer photon
    counts times alpha / 255)."""
    rng = np.random.default_rng(seed)
    L = ((H - R) // 2 + 1) ** 2
    root.mkdir(parents=True)
    for part, n in (("train", n_train), ("val", n_val)):
        alpha = rng.uniform(180, 200, (n,)).astype(np.float32)
        a = alpha[:, None, None, None, None]
        counts = rng.integers(0, 256, (n, 2, H, H, 3)).astype(np.float32)
        bd = np.zeros((n, H, H), np.float32)
        bd[:, ::6, :] = rng.uniform(0.75, 1.18, (n, (H + 5) // 6, H))
        arrays = {"alphas": alpha,
                  "params_src": rng.normal(scale=0.3, size=(n, 2, L, 19)).astype(np.float32),
                  "images_gt": counts / 255.0 * a,
                  "boundary_distances": rng.integers(0, 20, (n, H, H)).astype(np.float32),
                  "boundary_depths": bd,
                  "images_ny": np.clip(np.round(counts / 255.0 * a
                                                + rng.normal(0, 2, counts.shape)), 0, 255)}
        for name, arr in arrays.items():
            np.save(root / f"{name}_{part}.npy", arr)


def write_test_set(root: Path, n: int, size: int, seed: int):
    """A test set in the generator's layout: smooth ramps as photon counts,
    depth maps of two planes."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    alphas = rng.uniform(180, 200, n).astype(np.float32)
    imgs = []
    for a in alphas:
        p, q = rng.uniform(0.2, 0.8, 2)
        base = np.stack([p * xx + (1 - p) * yy, q * yy + 0.2, 0.5 * (xx + yy)], -1)
        pair = np.clip(np.stack([base, base[::-1]]) + rng.normal(0, 0.05, (2, size, size, 3)),
                       0, 1)
        imgs.append(np.round(pair * a))
    root.mkdir(parents=True)
    np.save(root / "images_ny.npy", np.stack(imgs).astype(np.uint8))
    np.save(root / "depth_maps.npy", np.stack(
        [np.where(yy < rng.uniform(0.3, 0.7), 0.8, 1.1) for _ in alphas]).astype(np.float32))
    np.save(root / "alphas.npy", alphas)


def bn_batch():
    """A layer's weights and a global batch of 4 for the BatchNorm check."""
    rng = np.random.default_rng(5)
    x = rng.normal(0.3, 1.5, (4, 6, 5, 5)).astype(np.float32)
    cot = rng.normal(0, 1, x.shape).astype(np.float32)
    w, b = rng.uniform(0.5, 1.5, 6).astype(np.float32), rng.normal(0, 0.2, 6).astype(np.float32)
    return x, cot, w, b


def bn_step(x, cot, w, b, mesh):
    """One train-mode forward and backward of BatchNorm2d on the rank's
    share: (output share, running mean, running var, weight and bias
    gradients summed over the ranks)."""
    bn = BatchNorm2d(6)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(w))
        bn.bias.copy_(torch.from_numpy(b))
    share = pm.data_sharding(len(x), mesh)
    y = bn.train()(torch.from_numpy(x[share]))
    (y * torch.from_numpy(cot[share])).sum().backward()
    grads = torch.cat([bn.weight.grad, bn.bias.grad])
    return (y.detach().numpy(), bn.running_mean.numpy().copy(), bn.running_var.numpy().copy(),
            pm.all_reduce(grads, mesh).numpy())


def local_argv(root: Path, tag: str):
    return ["--cuda", "cpu", "--data_path", str(root / "local"), "--batch_size", "8",
            "--epoch_num", "2", "--log_path", str(root / f"logs_local_{tag}"),
            "--model_path", str(root / f"w_local_{tag}")]


def global_args(root: Path, tag: str):
    return get_args("global_train", argv=[
        "--img_size", str(H), str(H), "--data_path", str(root / "global"),
        "--log_path", str(root / f"logs_global_{tag}"),
        "--model_path", str(root / f"w_global_{tag}"), "--batch_size", "4",
        "--epoch_num", "2", "--dynamic_epoch", "2", "2", "4"])


def eval_args(root: Path, big: bool):
    args = get_args("eval", big=big, argv=["--data_path", str(root / ("t55" if big else "t41"))])
    args.img_size = [BLOCK, BLOCK] if big else [H, H]
    if big:
        args.big_img_size, args.n_margin_patch, args.block_chunk = [BIG, BIG], MARGIN, 1
    return args


def modules():
    return random_modules(torch.Generator().manual_seed(3), "cpu")


def quiet(fn, *a, **k):
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        return fn(*a, **k), log.getvalue()


def eval_big(root: Path, mesh=None):
    """``run_eval_big``'s result and log, and the maps its visualizer got."""
    maps = {}
    res = quiet(pipeline_big.run_eval_big, eval_args(root, True), modules(), device="cpu",
                mesh=mesh, visualizer=lambda j, img, gt, out: maps.update(out))
    return res, maps


def rank_job(root: str) -> dict:
    """Everything the two ranks run; rank 0's results and logs."""
    root = Path(root)
    mesh = pm.make_mesh(2)
    out = {"bn": bn_step(*bn_batch(), mesh)}
    out["local"], _ = quiet(cli.local_train_main, local_argv(root, "dp") + ["--dp_devices", "2"])
    quiet(run_global_training, global_args(root, "dp"), device="cpu", mesh=mesh)
    out["global"] = np.load(root / "logs_global_dp" / "loss_curve_exp_global_stage.npy")
    out["eval"] = quiet(pipeline.run_eval, eval_args(root, False), modules(), device="cpu",
                        mesh=mesh)
    out["eval_big"], out["big_maps"] = eval_big(root, mesh)
    out["tensor"] = torch.arange(5.0) * (mesh.rank + 1)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """World size 2 (rank 0's and rank 1's results) and one process, on the
    same data."""
    root = tmp_path_factory.mktemp("dp")
    write_local_set(root / "local")
    write_global_set(root / "global")
    write_test_set(root / "t41", 3, H, 7)
    write_test_set(root / "t55", 1, BIG, 8)
    two = pm.launch(rank_job, 2, args=(str(root),), timeout=TIMEOUT)
    one = {"local": quiet(cli.local_train_main, local_argv(root, "one"))[0]}
    quiet(run_global_training, global_args(root, "one"), device="cpu")
    one["global"] = np.load(root / "logs_global_one" / "loss_curve_exp_global_stage.npy")
    one["eval"] = quiet(pipeline.run_eval, eval_args(root, False), modules(), device="cpu")
    one["eval_big"], one["big_maps"] = eval_big(root)
    return dict(root=root, two=two, one=one)


def test_batchnorm_normalises_over_the_global_batch(runs):
    x, cot, w, b = bn_batch()
    y, mean, var, grads = bn_step(x, cot, w, b, pm.make_mesh())
    for rank, (y_r, mean_r, var_r, grads_r) in enumerate(r["bn"] for r in runs["two"]):
        share = pm.data_sharding(len(x), pm.Mesh(size=2, rank=rank))
        np.testing.assert_allclose(y_r, y[share], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(mean_r, mean, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(var_r, var, rtol=1e-6, atol=1e-6)
        # sums of 100 products each, in another order
        np.testing.assert_allclose(grads_r, grads, rtol=0, atol=1e-6 * np.abs(grads).max())


@pytest.mark.parametrize("trainer", ["local", "global"])
def test_train_curves_match_one_process(runs, trainer):
    one = runs["one"][trainer]
    one = one["curve"] if trainer == "local" else one
    for r in runs["two"]:
        two = r[trainer]["curve"] if trainer == "local" else r[trainer]
        assert np.isfinite(two).all() and two.shape == one.shape == (2,)
        np.testing.assert_allclose(two, one, rtol=2e-3, atol=1e-5)
    if trainer == "local":
        assert (runs["root"] / "w_local_dp" / "best_run_exp_local_stage.pth").exists()
        assert runs["two"][0]["local"]["steps"] == 2 * 2


@pytest.mark.parametrize("which", ["eval", "eval_big"])
def test_eval_metrics_match_one_process(runs, which):
    (res_one, log_one), (res_two, log_two) = runs["one"][which], runs["two"][0][which]
    assert runs["two"][1][which][0] is None        # rank 1 scores nothing
    for k in ("delta1", "delta2", "delta3", "rmse", "absrel"):
        assert res_two[k] == res_one[k], k
    order = lambda log: [int(j) for j in re.findall(r"Image pair #(\d+):", log)]  # noqa: E731
    assert order(log_two) == order(log_one) == list(range(3 if which == "eval" else 1))


def test_eval_big_maps_match_one_process(runs):
    one, two = runs["one"]["big_maps"], runs["two"][0]["big_maps"]
    assert set(two) == set(one) and len(one) == 7
    for k, v in one.items():
        np.testing.assert_array_equal(two[k], v, err_msg=k)
    assert not runs["two"][1]["big_maps"]          # rank 1 visualizes nothing


def test_rank_results_come_back_by_value(runs):
    """A tensor a rank returns is read after the rank has exited."""
    for rank, r in enumerate(runs["two"]):
        assert torch.equal(r["tensor"], torch.arange(5.0) * (rank + 1))


def test_cli_launches_the_ranks(runs, monkeypatch):
    """``eval --dp_devices 2 --cuda cpu`` starts its ranks from this
    process and returns rank 0's averages, those of one process. The CLI
    sets its launch no wall-clock limit (a training run may last days);
    here the launch is held to the test's own."""
    import blurry_edges_tpu_torch.parallel as par

    asked = []

    def bounded_launch(fn, world_size, **kw):
        asked.append(kw.get("timeout"))
        return pm.launch(fn, world_size, **{**kw, "timeout": TIMEOUT})

    monkeypatch.setattr(par, "launch", bounded_launch)
    root = runs["root"]
    mp = root / "w_eval"
    mp.mkdir(exist_ok=True)
    mods = modules()
    torch.save(mods.local_model.state_dict(), mp / "best_run_exp_local_stage.pth")
    torch.save(mods.global_model.state_dict(), mp / "best_run_exp_global_stage.pth")
    argv = ["--cuda", "cpu", "--img_size", str(H), str(H), "--data_path", str(root / "t41"),
            "--model_path", str(mp), "--log_path", str(root / "logs_eval"), "--vis_max", "1"]
    one, _ = quiet(cli.eval_main, argv)
    two, _ = quiet(cli.eval_main, argv + ["--dp_devices", "2"])
    assert asked == [None]
    for k in ("delta1", "delta2", "delta3", "rmse", "absrel"):
        assert two[k] == one[k], k


def test_mesh_helpers_on_one_device():
    mesh = pm.make_mesh()
    assert (mesh.size, mesh.rank, mesh.distributed, pm.in_rank()) == (1, 0, False, False)
    with pytest.raises(RuntimeError, match="ranks"):
        pm.make_mesh(2)
    shard = {"a": torch.arange(10.0)[:, None], "b": torch.arange(10, dtype=torch.uint8)}
    rows = pm.gather_rows(shard, 0, np.array([7, 2, 2]), mesh)
    assert rows["a"][:, 0].tolist() == [7.0, 2.0, 2.0] and rows["b"].tolist() == [7, 2, 2]
    shares = [pm.data_sharding(7, pm.Mesh(size=3, rank=r)) for r in range(3)]
    assert [(s.start, s.stop) for s in shares] == [(0, 3), (3, 6), (6, 7)]


def test_cli_refuses_more_ranks_than_cards():
    n = torch.cuda.device_count()
    with pytest.raises(SystemExit, match="CUDA devices"):
        cli.local_train_main(["--cuda", "cuda:0", "--dp_devices", str(n + 2)])
