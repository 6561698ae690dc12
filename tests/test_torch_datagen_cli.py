"""The port's training-data modes through its command line, on the CPU, at a
tiny size: ``gen_trainval``, ``local_train`` (with a resumed epoch),
``global_precal``, ``global_train`` on the tokens it wrote, ``gen_test``
(147-style and ``--big``), then ``eval`` on the generated set with the
weights the chain trained (``eval_big`` on a generated set is
tests/test_torch_big.py's ``run_eval_big`` at the same geometry, and
chip_smoke.py's on the card). Checks the files each mode writes
(names, shapes, float32, integer noisy counts in [0, round(alpha)], boundary
distance 0 on every boundary pixel, depths inside Z_range), that
``load_inference_modules`` loads the local stage ``local_train`` wrote, and
that a run stopped after 2 epochs and resumed for a third ends with the
weights of a run that did not stop (bit for bit: one CPU process, the same
batches from the epoch-derived shuffle).
"""


import numpy as np
import pytest
import torch

from blurry_edges_tpu_torch import cli
from blurry_edges_tpu_torch.config import get_args
from blurry_edges_tpu_torch.train import local
from blurry_edges_tpu_torch.train.checkpoint import load_checkpoint
from blurry_edges_tpu_torch.models.weights import load_inference_modules

torch.set_num_threads(1)

H, N_TRAIN, N_VAL = 41, 4, 4


def test_cli_routes_the_new_modes(monkeypatch):
    seen = []
    for name in ("gen_trainval", "gen_test", "local_train", "global_precal"):
        monkeypatch.setitem(cli.MODES, name, lambda argv, name=name: seen.append((name, argv)))
    cli.main(["gen_trainval", "--num_sample_train", "4"])
    cli.main(["gen_test", "--big"])
    cli.main(["local_train", "--epoch_num", "1"])
    cli.main(["global_precal"])
    assert seen == [("gen_trainval", ["--num_sample_train", "4"]), ("gen_test", ["--big"]),
                    ("local_train", ["--epoch_num", "1"]), ("global_precal", [])]


def local_args(root, weights, epochs):
    return get_args("local_train", argv=[
        "--data_path", str(root / "data" / "patches"), "--log_path", str(root / f"logs_{weights}"),
        "--model_path", str(root / weights), "--epoch_num", str(epochs), "--batch_size", "4",
        "--dynamic_epoch", "2"])


def test_chain_on_the_cpu(tmp_path, capsys):
    cpu = ["--cuda", "cpu"]
    data = tmp_path / "data"
    cli.main(["gen_trainval"] + cpu + ["--data_path", str(data), "--img_size", str(H), str(H),
                                       "--num_sample_train", str(N_TRAIN),
                                       "--num_sample_val", str(N_VAL)])
    for part, n in (("train", N_TRAIN), ("val", N_VAL)):
        a = np.load(data / f"alphas_{part}.npy")
        ny = np.load(data / f"images_ny_{part}.npy")
        assert ny.shape == (n, 2, H, H, 3) and ny.dtype == np.float32
        assert (ny == np.round(ny)).all() and ny.min() >= 0
        # clipped to alpha, then rounded: at most round(alpha)
        assert (ny <= np.round(a)[:, None, None, None, None]).all()
        bloc = np.load(data / f"boundary_locations_{part}.npy")
        dist = np.load(data / f"boundary_distances_{part}.npy")
        assert (bloc > 0).any() and (dist[bloc > 0] == 0).all() and (dist[bloc == 0] > 0).all()
        depth = np.load(data / f"image_depths_{part}.npy")
        assert depth.min() >= 0.75 and depth.max() <= 1.18
        assert np.load(data / f"derivative_maps_{part}.npy").shape == (n, 2, H, H, 3)
        p = np.load(data / "patches" / f"patches_ny_{part}.npy")
        assert p.shape == (2 * n, 21, 21, 3)
        pb = np.load(data / "patches" / f"boundary_locations_{part}.npy")
        pd = np.load(data / "patches" / f"boundary_distances_{part}.npy")
        assert (pd[pb > 0] == 0).all()

    # local_train: 2 epochs then a resumed third, against 3 straight epochs
    r2 = local.run_local_training(local_args(tmp_path, "w", 2), snapshot_every=1, device="cpu")
    r3 = local.run_local_training(local_args(tmp_path, "w", 3), snapshot_every=1, device="cpu")
    straight = local.run_local_training(local_args(tmp_path, "w_straight", 3), snapshot_every=1,
                                        device="cpu")
    assert r2["start_epoch"] == 0 and r3["start_epoch"] == 2 and r3["steps"] == N_TRAIN * 2 // 4
    assert "RESUMED at epoch 2" in capsys.readouterr().out
    got = load_checkpoint(str(tmp_path / "w" / "last_exp_local_stage"))["model"]
    want = load_checkpoint(str(tmp_path / "w_straight" / "last_exp_local_stage"))["model"]
    for k in want:
        assert torch.equal(got[k], want[k]), k
    np.testing.assert_array_equal(r3["curve"], straight["curve"])
    assert np.isfinite(r3["curve"]).all()
    assert (tmp_path / "logs_w" / "exp_local_stage_training.txt").exists()

    mods = load_inference_modules(get_args("eval", argv=["--model_path", str(tmp_path / "w")]),
                                  allow_random=True, device="cpu")
    best = load_checkpoint(str(tmp_path / "w" / "best_run_exp_local_stage"))
    for k, t in mods.local_model.state_dict().items():
        assert torch.equal(t, best[k]), k

    cli.main(["global_precal"] + cpu + ["--data_path", str(data), "--model_path",
                                        str(tmp_path / "w"), "--img_size", str(H), str(H)])
    tok = np.load(data / "params_src_train.npy")
    assert tok.shape == (N_TRAIN, 2, 121, 19) and tok.dtype == np.float32
    assert np.isfinite(tok).all()

    cli.main(["global_train"] + cpu + ["--data_path", str(data), "--model_path",
                                       str(tmp_path / "w"), "--log_path", str(tmp_path / "glog"),
                                       "--img_size", str(H), str(H), "--epoch_num", "1",
                                       "--batch_size", "2", "--dynamic_epoch", "2", "3", "5"])
    assert (tmp_path / "w" / "best_run_exp_global_stage.pth").exists()

    cli.main(["gen_test"] + cpu + ["--data_path", str(tmp_path / "data_test"), "--img_size",
                                   str(H), str(H), "--num_sample_test", "2"])
    cli.main(["gen_test", "--big"] + cpu + ["--data_path", str(tmp_path / "data_test"),
                                            "--big_img_size", "71", "71",
                                            "--num_sample_test", "1"])
    big = np.load(tmp_path / "data_test_big" / "images_ny.npy")
    assert big.shape == (1, 2, 71, 71, 3)
    with pytest.raises(FileNotFoundError, match="instances_val2017.json"):
        cli.main(["gen_test", "--coco"] + cpu + ["--data_path", str(tmp_path / "x")])

    w = ["--model_path", str(tmp_path / "w"), "--log_path", str(tmp_path / "elog"),
         "--vis_max", "0"]
    res = cli.eval_main(cpu + w + ["--data_path", str(tmp_path / "data_test"),
                                   "--img_size", str(H), str(H)])
    assert all(np.isfinite(v) for v in res.values()) and res["pairs_per_sec"] > 0


def test_local_train_refuses_data_parallel(tmp_path):
    """Two data-parallel devices outside a rank: the trainer refuses rather
    than train on one (the CLI starts the ranks, parallel.launch); on CUDA
    the CLI refuses more ranks than visible cards."""
    args = get_args("local_train", argv=["--dp_devices", "2", "--data_path", str(tmp_path)])
    with pytest.raises(RuntimeError, match="2 ranks"):
        local.run_local_training(args, device="cpu")
    with pytest.raises(SystemExit, match="CUDA devices"):
        cli.main(["local_train", "--cuda", "cuda:0", "--dp_devices",
                  str(torch.cuda.device_count() + 2), "--data_path", str(tmp_path)])
