"""The port's bfloat16 networks and estimator (``--serve_dtype bfloat16``)
against the benchmark's plain bfloat16 reference
(``benchmark/reference/models_lowp.py``), on the CPU, with seeded random
weights at the published widths and small inputs. No JAX.

The reference places the bfloat16 rounding where the JAX package's Flax
modules do and takes its products, norms and reductions from PyTorch's own
bfloat16 operations, so where the port rounds at the same points the two
agree to the bit: every gap below reads 0 here. The tolerances sit far
below what one moved rounding point gives, so they pin the rounding points
rather than land near them. Each is shown to fail under the fp8 control
(every product's operands in float8 e4m3) and under a rounding point moved
in the reference: the softmax rounded once, as ``torch.softmax`` rounds a
bfloat16 input, for the global stage and the estimator; Smish's sigmoid
rounded once for the local CNN, and for the U-Net the bias added to the
product in float32 before one rounding; those two have no softmax.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import judge
from benchmark.inputs.pairs import make_pairs
from benchmark.reference import models_lowp as lowp
from benchmark.reference.estimator import Estimator
from blurry_edges_tpu_torch.config import CamConfig, GridConfig, PatchConfig
from blurry_edges_tpu_torch.eval import pipeline
from blurry_edges_tpu_torch.models.weights import random_modules

ROOT = Path(__file__).resolve().parent.parent
H = 41

# Mean |port - reference| over mean |reference| of a network's output. Both
# run the same library kernels at the same rounding points, so they agree
# to the bit (0 here); a moved rounding point changes a share of the
# outputs by a bfloat16 ulp (2^-8 relative): 2.2e-3 (Smish's sigmoid
# rounded once), 3.6e-3 (the U-Net's bias unrounded), 9.3e-3 (the softmax
# rounded once); the fp8 control 5e-2 to 8e-2.
NET_TOL = 1e-4

# The estimator's judge numbers (benchmark/judge.py) on a 41x41 pair. The
# float32 chain between the networks (colors, tokens, render, fold) is the
# same arithmetic in both on the CPU and agrees to the bit, as do the
# networks, so each reads 0. One moved rounding point reaches every token
# through the attention: the softmax rounded once moves the folded depth by
# 1.2% at the median (a share 0.83 off by 1e-3) and the confidence by
# 1.5e-2 on the mean; the fp8 control 3.7%, 0.98 and 2.4e-2.
EST_TOL = {"conf_mean_abs": 1e-6, "depth_rel_p50": 1e-6, "depth_off_share": 1e-3,
           "densify_gap": 1e-6}


def softmax_once(x):
    return torch.softmax(x, dim=-1)


def bias_unrounded(y, bias, channel_dim: int):
    """The bias added to the bfloat16 product in float32 and the sum rounded
    once, where Flax rounds the bias to bfloat16 and adds in bfloat16."""
    if bias is None:
        return y
    shape = [1] * y.dim()
    shape[channel_dim] = -1
    return (y.float() + bias.view(shape)).to(lowp.BF16)


MOVED = {
    "softmax_once": lambda mp: mp.setattr(lowp, "softmax", softmax_once),
    "sigmoid_once": lambda mp: mp.setattr(lowp, "sigmoid", torch.sigmoid),
    "bias_unrounded": lambda mp: mp.setattr(lowp, "_biased", bias_unrounded),
}


@pytest.fixture(scope="module")
def mods():
    return random_modules(torch.Generator().manual_seed(0), device="cpu", unet=True,
                          dtype=torch.bfloat16)


def inputs():
    rng = np.random.default_rng(1)
    return {"local": torch.from_numpy(rng.uniform(0, 1, (128, 21, 21, 3)).astype(np.float32)),
            "global": torch.from_numpy(rng.normal(0, 1, (1, 121, 38)).astype(np.float32)),
            "unet": torch.from_numpy(rng.uniform(0, 1.2, (1, 1, H, H)).astype(np.float32))}


def network(mods, name):
    return {"local": mods.local_model, "global": mods.global_model, "unet": mods.unet_model}[name]


def net_gap(mods, name, control=False) -> float:
    x = inputs()[name]
    port = network(mods, name)
    ref = lowp.build(name, port.state_dict(), "cpu", control=control)
    with torch.no_grad():
        got, want = port(x).float().double(), ref(x).double()
    assert want.dtype == torch.float64 and got.shape == want.shape
    return float((got - want).abs().mean() / want.abs().mean())


@pytest.mark.parametrize("name", ["local", "global", "unet"])
def test_network_matches_the_bf16_reference(mods, name):
    assert net_gap(mods, name) <= NET_TOL


NET_CASES = [("local", "control"), ("local", "sigmoid_once"), ("global", "control"),
             ("global", "softmax_once"), ("unet", "control"), ("unet", "bias_unrounded")]


@pytest.mark.parametrize("name,case", NET_CASES, ids=[f"{n}-{c}" for n, c in NET_CASES])
def test_network_tolerance_fails_off_the_rounding_points(mods, monkeypatch, name, case):
    if case != "control":
        MOVED[case](monkeypatch)
    assert net_gap(mods, name, control=case == "control") > NET_TOL


def config():
    cfg = json.loads((ROOT / "benchmark/configs/be147-bf16.json").read_text())
    cfg["img_size"] = H
    cfg["scene"]["n_shapes"] = 4
    return cfg


@pytest.fixture(scope="module")
def served(mods):
    """The port's bf16 estimator's answer to one 41x41 pair, and the pair."""
    cfg = config()
    patch = PatchConfig(R=cfg["R"], w=cfg["w"], alpha_lambda=cfg["alpha_lambda"],
                        stride=cfg["stride"], mag=cfg["mag"])
    est = pipeline.make_depth_estimator(mods, patch, GridConfig(H, H, cfg["R"], cfg["stride"]),
                                        CamConfig(**cfg["cam"]), densify="pp",
                                        rho_prime=cfg["rho_prime"], device="cpu")
    pair = make_pairs(2 ** 31 + 11, 1, H, cfg, torch.device("cpu"))
    out = est(pair[0].numpy())
    return pair, {k: out[k][0].numpy() for k in ("depth_final", "confidence", "global_depth")}


def estimator_numbers(mods, served, control=False) -> dict:
    pair, got = served
    nets = {k: lowp.build(k, network(mods, k).state_dict(), "cpu", control=control)
            for k in ("local", "global", "unet")}
    ref = Estimator(nets, config())
    (want,) = ref(pair)
    dense = ref.densify(*(torch.from_numpy(got[k]) for k in ("global_depth", "confidence")))
    assert (want["confidence"] > 0).float().mean() > 0.25    # a share of the pixels is judged
    return judge.serve_numbers(got, {k: v.numpy() for k, v in want.items()}, dense.numpy())


def test_estimator_matches_the_reference_estimator(mods, served):
    numbers = estimator_numbers(mods, served)
    assert all(numbers[k] <= t for k, t in EST_TOL.items()), numbers


@pytest.mark.parametrize("case", ["control", "softmax_once"])
def test_estimator_tolerances_fail_off_the_rounding_points(mods, served, monkeypatch, case):
    if case != "control":
        MOVED[case](monkeypatch)
    numbers = estimator_numbers(mods, served, control=case == "control")
    failed = {k for k, t in EST_TOL.items() if numbers[k] > t}
    assert {"conf_mean_abs", "depth_rel_p50", "depth_off_share"} <= failed, numbers
