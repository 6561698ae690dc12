"""The seeded inputs: photon statistics of the pairs, the weights' init and
keys, the training set's layout; the same seed gives the same inputs."""

import math

import numpy as np
import pytest
import torch

from benchmark.harness import load_json
from benchmark.inputs import pairs as P
from benchmark.inputs.trainset import make_trainset
from benchmark.inputs.weights import make_weights
from benchmark.reference import models as ref
from benchmark.test_benchmark_dispatch import ROOT

CFG = load_json(ROOT / "benchmark/configs/be147.json")
CPU = torch.device("cpu")


def test_photon_noise_statistics():
    """Poisson shot noise plus read noise of sigma 2, before the clip and
    the rounding: mean alpha x, variance alpha x + 4, at mid intensity."""
    g = torch.Generator().manual_seed(3)
    alpha, x = 190.0, 0.5
    clean = torch.full((1, 400_000), 255.0 * x)
    ny = P.photon_noise(g, clean, torch.tensor([alpha]), 2.0) * alpha
    lam = alpha * x
    assert ny.mean().item() == pytest.approx(lam, abs=0.05)
    assert ny.var().item() == pytest.approx(lam + 4.0 + 1 / 12, rel=0.02)   # + rounding
    assert torch.allclose(ny, torch.round(ny), atol=1e-3) and ny.max() <= alpha and ny.min() >= 0


def test_pairs_are_seeded_in_range_and_defocused_apart():
    a = P.make_pairs(2 ** 31 + 5, 2, 41, CFG, CPU)
    b = P.make_pairs(2 ** 31 + 5, 2, 41, CFG, CPU)
    assert a.shape == (2, 2, 41, 41, 3) and torch.equal(a, b)
    assert not torch.equal(a, P.make_pairs(2 ** 31 + 6, 2, 41, CFG, CPU))
    assert a.min() >= 0 and a.max() <= 1 + 0.5 / 180   # round(alpha) may pass alpha
    g = torch.Generator().manual_seed(1)
    clean = P.clean_pairs(g, 1, 41, CFG["scene"], CFG["cam"], CFG["mag"], CPU)
    assert (clean[0, 0] - clean[0, 1]).abs().max() > 1.0       # the two apertures' blurs differ


def test_blur_of_the_camera_model():
    z = torch.tensor([1.0])
    s = P.blur_sigma_px(z, 10.0, CFG["cam"], CFG["mag"])
    assert s.item() == pytest.approx(abs((1 - 10.0) * 0.1104 + 1) * 0.003 / (5.86e-6 * 4), rel=1e-5)


def test_weights_keys_and_init():
    w = make_weights(11, CPU)
    for name, cls in (("local", ref.LocalStage), ("global", ref.GlobalStage), ("unet", ref.UNet)):
        assert set(w[name]) == set(cls().state_dict())
        ref.build(name, w[name], CPU)                         # loads strictly
    k = w["local"]["layer1.0.conv1.0.weight"]                 # (256, 96, 3, 3), Xavier
    std = math.sqrt(2.0 / (9 * 96 + 9 * 256))
    assert k.std().item() == pytest.approx(std, rel=0.02) and k.abs().max() <= 2 * std / 0.8796 + 1e-6
    u = w["unet"]["down2.maxpool_conv.1.double_conv.0.weight"]   # LeCun: fan in 9 x 128
    assert u.std().item() == pytest.approx(math.sqrt(1 / (9 * 128)), rel=0.02)
    assert torch.all(w["local"]["conv1.1.running_var"] == 1)
    assert torch.equal(w["global"]["generator.weight"], make_weights(11, CPU)["global"]["generator.weight"])


def test_trainset_layout():
    d = make_trainset(4, 10, 41, 121, CFG["train"]["data"], CPU)
    assert d["input_param"].dtype == torch.bfloat16 and d["input_param"].shape == (10, 2, 121, 19)
    assert d["imgs_u8"].dtype == torch.uint8 and d["imgs_u8"].shape == (10, 2, 41, 41, 3)
    assert torch.equal(d["imgs_u8"][:, 0], d["imgs_u8"][:, 1])
    assert d["bndry_dist"].dtype == torch.int32
    edge = d["bndry_depth"] > 0
    assert 0.05 < edge.float().mean() < 0.15
    assert d["bndry_depth"][edge].min() >= 0.75 and d["bndry_depth"].max() <= 1.18
    assert np.array_equal(d["input_param"].float().numpy(),
                          make_trainset(4, 10, 41, 121, CFG["train"]["data"], CPU)["input_param"].float().numpy())
