"""The LocalStage's tail after each convolution: its plain chain
(``models/local_stage.py::local_epilogue_plain``), its dispatch, and on a
CUDA card its kernel (``ops/local_epilogue.py``).

On the CPU (tier 1): ``local_epilogue_plain`` is the modules' own chain to
the bit at every kind of junction; the LocalStage's forward equals the
chain it had before the tail went through ``local_epilogue`` (float32 and
bfloat16, eval and train mode with gradients); the kernel is taken only for
float32 CUDA inputs, norms in eval mode and autograd off.

On the card (marker ``cuda``; no JAX here, so from the repository root
``python -m pytest --noconftest -m cuda tests/test_torch_local_epilogue.py``)
the kernel at the ten junctions' shapes, at a 147x147 pair's 8,192 patches,
4 pairs' (and a 587x587 chunk's) 32,768 and a ragged 1,001: Smish and the
max-pool equal PyTorch's to the bit on the kernel's own BatchNorm; that
BatchNorm and the sum lie within 2 float32 ulps of the modules' (cuDNN's
inference BatchNorm, then the add); the kernel repeats to the bit; the
wrapper refuses what the kernel does not take; a float32 estimator launches
it ten times a LocalStage forward, a bfloat16 one never.
"""

import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from blurry_edges_tpu_torch.models import local_stage
from blurry_edges_tpu_torch.models.batchnorm import BatchNorm1d, BatchNorm2d
from blurry_edges_tpu_torch.models.local_stage import LocalStage, local_epilogue_plain
from blurry_edges_tpu_torch.ops import local_epilogue as le
from blurry_edges_tpu_torch.ops.local_epilogue import smish
from tests.local_epilogue_cases import (
    JUNCTIONS, biased, conv_biases, junction, kernel_errors, kernel_norm, make_norm)

torch.set_num_threads(1)


def module_chain(x, norm, residual, residual_norm, pool):
    """The tail as the LocalStage's modules computed it before it went
    through ``local_epilogue``."""
    y = norm(x)
    if residual is not None:
        y = y + (residual if residual_norm is None else residual_norm(residual))
    y = smish(y)
    if pool == (2, 2, 0):
        return F.max_pool2d(y, 2, 2)
    return y if pool is None else F.max_pool2d(y, pool[0], pool[1], padding=pool[2])


def parent_forward(m: LocalStage, x):
    """LocalStage.forward as the modules' chain computed it before."""
    def block(b, y):
        residual = y if b.downsample is None else b.downsample(y)
        return smish(b.conv2(b.conv1(y)) + residual)

    y = F.max_pool2d(m.conv1(x.permute(0, 3, 1, 2)), 3, 2, padding=1)
    y = F.max_pool2d(block(m.layer0[0], y), 3, 2, padding=1)
    y = block(m.layer3[0], block(m.layer2[0], block(m.layer1[0], y)))
    return m.fc(F.max_pool2d(y, 2, 2))


def seeded_local(seed: int, dtype=torch.float32) -> LocalStage:
    g = torch.Generator().manual_seed(seed)
    m = LocalStage(dtype=dtype)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.1)
        for mod in m.modules():
            if isinstance(mod, (BatchNorm1d, BatchNorm2d)):
                mod.running_mean.copy_(torch.randn(mod.num_features, generator=g) * 0.1)
                mod.running_var.copy_(torch.rand(mod.num_features, generator=g) + 0.5)
    return m


# ------------------------------------------------------------------ CPU


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(JUNCTIONS))
def test_plain_is_the_module_chain(name, dtype):
    a = junction(name, 3, torch.Generator().manual_seed(1), dtype=dtype)
    with torch.no_grad():
        got = local_epilogue_plain(a["x"], a["norm"], a["residual"], a["residual_norm"],
                                   a["pool"])
        want = module_chain(**a)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


def test_plain_adds_a_residual_without_norm():
    """A block of equal widths has no downsample: its input is added as it is."""
    g = torch.Generator().manual_seed(2)
    x, r = torch.randn((2, 8, 6, 6), generator=g), torch.randn((2, 8, 6, 6), generator=g)
    bn = make_norm(8, 6, g)
    with torch.no_grad():
        got = local_epilogue_plain(x, bn, r)
        assert torch.equal(got, smish(bn(x) + r))
        block = local_stage.ResidualBlock(8, 8).eval()
        want = smish(block.conv2(block.conv1(x)) + x)
        assert torch.equal(block(x), want)


@pytest.mark.parametrize("dtype, mode", [(torch.float32, "eval"), (torch.float32, "train"),
                                         (torch.bfloat16, "eval")],
                         ids=["float32-eval", "float32-train", "bfloat16-eval"])
def test_forward_equals_the_module_chain(dtype, mode):
    """The LocalStage's forward, its output, and in train mode its running
    statistics and its gradients, equal the modules' chain to the bit (the
    port trains only in float32)."""
    x = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (5, 21, 21, 3)).astype(np.float32))
    ours, theirs = seeded_local(4, dtype), seeded_local(4, dtype)
    for m in (ours, theirs):
        m.train(mode == "train")
    if mode == "eval":
        with torch.no_grad():
            assert torch.equal(ours(x), parent_forward(theirs, x))
        return
    got, want = ours(x), parent_forward(theirs, x)
    assert torch.equal(got, want)
    got.float().square().sum().backward()
    want.float().square().sum().backward()
    for (k, a), (_, b) in zip(ours.named_parameters(), theirs.named_parameters()):
        assert torch.equal(a.grad, b.grad), k
    for (k, a), (_, b) in zip(ours.named_buffers(), theirs.named_buffers()):
        assert torch.equal(a, b), k


def stand_in(device: str, dtype):
    """What ``fuses`` reads of a tensor, on any device this box can name."""
    return types.SimpleNamespace(device=torch.device(device), dtype=dtype)


@pytest.mark.parametrize("case", ["fused", "cpu", "bfloat16", "float64", "train", "grad",
                                  "residual_train", "bfloat16_layer"])
def test_dispatch(case):
    """The kernel only for a float32 input on CUDA, every module in eval
    mode and computing in float32, autograd off. (A bfloat16 LocalStage's
    first convolution takes the float32 patches and computes in bfloat16.)"""
    g = torch.Generator().manual_seed(5)
    conv, bn = local_stage.Conv2d(4, 4, 3), make_norm(4, 3, g)
    conv_r, bn_r = local_stage.Conv2d(4, 4, 1), make_norm(4, 3, g)
    modules = [conv.eval(), bn, conv_r.eval(), bn_r]
    x = stand_in("cpu" if case == "cpu" else "cuda",
                 {"bfloat16": torch.bfloat16, "float64": torch.float64}.get(case, torch.float32))
    if case == "train":
        bn.train()
    if case == "residual_train":
        bn_r.train()
    if case == "bfloat16_layer":
        conv.compute_dtype = torch.bfloat16
    with torch.set_grad_enabled(case == "grad"):
        assert le.fuses(x, *modules) is (case == "fused")


def test_the_cpu_never_reaches_the_kernel(monkeypatch):
    """A float32 LocalStage in eval mode under no_grad on the CPU runs the
    plain chain at every junction."""
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel was called on the CPU")

    monkeypatch.setattr(le, "local_epilogue_cuda", refuse)
    monkeypatch.setattr(local_stage, "local_epilogue", refuse)
    calls = []
    real = local_stage.local_epilogue_plain
    monkeypatch.setattr(local_stage, "local_epilogue_plain",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    m = seeded_local(6).eval()
    with torch.no_grad():
        m(torch.rand((2, 21, 21, 3)))
    assert len(calls) == 10


def test_plain_chain_reads_the_models_smish(monkeypatch):
    """The plain chain applies the name ``smish`` of ``models/local_stage.py``
    at all ten junctions (the function the kernel matches, from
    ``ops/local_epilogue.py``), so a change made there reaches every one:
    the bfloat16 benchmark cell's rounding faults patch it so."""
    assert local_stage.smish is le.smish
    calls = []
    monkeypatch.setattr(local_stage, "smish", lambda x: calls.append(x.dtype) or le.smish(x))
    m = seeded_local(13, torch.bfloat16).eval()
    with torch.no_grad():
        m(torch.rand((2, 21, 21, 3)))
    assert calls == [torch.bfloat16] * 10


def test_channels_per_block():
    """With a pool, a block takes the most channels of an image (a multiple
    of 4 dividing C) that keep it within TILE_FLOATS floats, at least 4."""
    for (C, side), want in (((64, 21), 32), ((96, 11), 96), ((256, 6), 256), ((384, 6), 384),
                            ((12, 140), 4)):
        assert le.channels_per_block(C, side, side) == want


def metric(name):
    from benchmark import harness

    root = Path(__file__).resolve().parent.parent
    return harness.load_module(root / "benchmark" / "metrics" / f"{name}.py").read


def traced(kernels: dict, requests=2, pairs=4):
    """A run's record with a profiled sub-window of ``requests`` requests
    of ``pairs`` pairs and these kernels' durations (s) by name."""
    return dict(latencies_s=[0.1] * 5, pairs=5 * pairs,
                trace=dict(kernels=kernels, calls=requests))


KERNELS = {"void (anonymous namespace)::local_epilogue_kernel<true>(...)": [1e-3] * 4,
           "void (anonymous namespace)::local_epilogue_pool_kernel<false>(...)": [2e-3] * 6,
           "void cudnn::bn_fw_inf_1C11_kernel_NHWC<float, float, true, true>": [5e-3]}


def test_kernel_ms_reader():
    """Device ms a pair of every launch named local_epilogue, else None."""
    read = metric("kernels.local_epilogue.ms")
    assert read(traced(KERNELS)) == pytest.approx(1e3 * (4e-3 + 12e-3) / 8)
    assert read(traced({k: v for k, v in KERNELS.items() if "cudnn" in k})) is None
    assert read(dict(latencies_s=[0.1], pairs=1)) is None


def test_launches_reader(monkeypatch):
    """Launches over the local_stage span's calls, else None."""
    from benchmark import spans

    read = metric("kernels.local_epilogue.launches")
    monkeypatch.setattr(spans, "summary", lambda: {"local_stage": {"calls": 2}})
    assert read(traced(KERNELS)) == 5.0
    assert read(traced({})) is None
    monkeypatch.setattr(spans, "summary", lambda: {})
    assert read(traced(KERNELS)) is None
    assert read(dict(latencies_s=[0.1], pairs=1)) is None


def test_readers_list_the_float32_serve_cells():
    from benchmark import harness

    root = Path(__file__).resolve().parent.parent
    m = harness.load_json(root / "BENCHMARK.json")
    cells = {w["name"] for w in m["workloads"]}
    for name in ("kernels.local_epilogue.ms", "kernels.local_epilogue.launches"):
        (entry,) = [e for e in m["per_layer"] if e["name"] == name]
        assert entry["workloads"] == ["be147.serve", "be587.serve", "be147.serve-x4"]
        assert set(entry["workloads"]) <= cells and entry["moves"] == "pairs_per_s"
        assert entry["layer"] == "LocalStage CNN (models/local_stage.py)"


# ------------------------------------------------------------------ card

SIZES = {"147": 8192, "x4": 32768, "ragged": 1001}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture
def free_card(dev):
    yield dev
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("trivial", [False, True], ids=["stats", "fresh"])
@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("name", list(JUNCTIONS))
def test_kernel_matches_plain(free_card, name, size, trivial):
    """The convolution's bias added as PyTorch adds it; Smish and the pool
    to the bit on the kernel's BatchNorm. That BatchNorm within 2 ulps of
    the size it works at (the sum within 6) from the exact one on the same
    float32 scale, the bounds of its two roundings (x - mean; the fma); with
    a fresh BatchNorm's statistics the whole output equal to the plain
    chain's (cuDNN's BatchNorm) to the bit. The output in the input's
    layout, repeating to the bit. Prints the largest distance from cuDNN's
    BatchNorm and sum, in ulps of their size."""
    g = torch.Generator().manual_seed(7)
    a = junction(name, SIZES[size], g, free_card, trivial)
    x, norm, r, rn, pool = a["x"], a["norm"], a["residual"], a["residual_norm"], a["pool"]
    b = conv_biases(a, g)
    with torch.no_grad():
        got = le.local_epilogue_cuda(x, norm, r, rn, pool, **b)
        again = le.local_epilogue_cuda(x, norm, r, rn, pool, **b)
        plain = local_epilogue_plain(biased(x, b["bias"]), norm,
                                     biased(r, b.get("residual_bias")), rn, pool)
    assert got.shape == plain.shape and got.dtype == torch.float32
    assert got.stride() == plain.stride()
    assert torch.equal(got, again), "the kernel does not repeat to the bit"
    equal, errs = kernel_errors(got, a, b)
    print(f"{name} {size} {'fresh' if trivial else 'stats'}: in ulps of the size, kernel "
          f"from exact {errs['exact']:.3f}, from cuDNN {errs['cudnn']:.3f}, cuDNN from exact "
          f"{errs['cudnn_exact']:.3f}; equal to plain {torch.eq(got, plain).sum().item()} of "
          f"{got.numel()}")
    assert equal, "Smish or the pool is off on its BatchNorm"
    assert errs["exact"] <= (6.0 if r is not None else 2.0)
    if trivial:
        assert errs["cudnn"] == 0.0 and torch.equal(got, plain)


@pytest.mark.cuda
def test_kernel_handles_nan_inf_and_no_residual_norm(dev):
    """NaN and infinities pass through Smish and the pool as PyTorch's, and
    a residual without a norm is added as it is."""
    g = torch.Generator().manual_seed(8)
    a = junction("layer0.sum", 64, g, dev)
    x = a["x"]
    mem = x.as_strided((x.numel(),), (1,))          # in storage order
    mem[::97] = float("nan")
    mem[5::89] = float("inf")
    mem[7::83] = -float("inf")
    with torch.no_grad():
        got = le.local_epilogue_cuda(x, a["norm"], a["residual"], None, a["pool"])
        want = F.max_pool2d(smish(kernel_norm(a["norm"], x) + a["residual"]), *a["pool"])
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(), want.nan_to_num())


@pytest.mark.cuda
def test_wrapper_refuses(dev):
    g = torch.Generator().manual_seed(9)
    a = junction("layer1.sum", 8, g, dev)
    x, norm, r, rn = a["x"], a["norm"], a["residual"], a["residual_norm"]
    with pytest.raises(TypeError):
        le.local_epilogue_cuda(x.double(), norm)
    with pytest.raises(ValueError):                        # not contiguous
        le.local_epilogue_cuda(x.transpose(2, 3), norm)
    with pytest.raises(ValueError):                        # NCHW, not channels-last
        le.local_epilogue_cuda(x.contiguous(), norm)
    shifted = torch.empty(x.numel() + 1, device=dev)[1:].view(x.shape)   # 4 bytes in
    with pytest.raises(ValueError):                        # not on 16 bytes
        le.local_epilogue_cuda(shifted, norm)
    with pytest.raises(ValueError):                        # residual of another shape
        le.local_epilogue_cuda(x, norm, r[:4], rn)
    with pytest.raises(ValueError):                        # a norm of another width
        le.local_epilogue_cuda(x, make_norm(128, 6, g).to(dev))
    with pytest.raises(ValueError):                        # a norm left on the CPU
        le.local_epilogue_cuda(x, make_norm(256, 6, g))
    with pytest.raises(ValueError):                        # a residual norm, no residual
        le.local_epilogue_cuda(x, norm, None, rn)
    with pytest.raises(ValueError):                        # padding over half the window
        le.local_epilogue_cuda(x, norm, pool=(2, 2, 2))
    with pytest.raises(ValueError):                        # 3-D input
        le.local_epilogue_cuda(x[:, :, 0], norm)
    with pytest.raises(ValueError):                        # channels not a multiple of 4
        le.local_epilogue_cuda(torch.zeros((8, 6, 6, 6), device=dev), make_norm(6, 6, g).to(dev))
    with pytest.raises(ValueError):                        # the CPU
        le.local_epilogue_cuda(x.cpu(), norm)


@pytest.mark.cuda
@pytest.mark.parametrize("fresh", [True, False], ids=["fresh", "stats"])
def test_local_stage_fused_against_plain(free_card, fresh):
    """The whole CNN on the card, 8,192 patches: the fused forward against
    the modules' chain (autograd on takes it): to the bit with fresh
    BatchNorm statistics (PyTorch's default initialisation, as the
    benchmark's weights have), and within float32 noise of the output's
    scale with random ones."""
    torch.manual_seed(12)
    m = (LocalStage() if fresh else seeded_local(12)).to(free_card).eval()
    x = torch.rand((8192, 21, 21, 3), device=free_card)
    le.reset_launch_counts()
    with torch.no_grad():
        fused = m(x)
    assert le.launch_counts()["local_epilogue"] == 10
    with torch.enable_grad():
        plain = m(x).detach()
    assert le.launch_counts()["local_epilogue"] == 10
    gap = (fused - plain).abs().max().item() / plain.abs().max().item()
    print(f"LocalStage fused vs plain, {'fresh' if fresh else 'random'} statistics: largest gap "
          f"{gap:.3e} of the output's scale; equal {torch.eq(fused, plain).sum().item()} of "
          f"{fused.numel()}")
    if fresh:
        assert torch.equal(fused, plain)
    else:
        assert gap < 1e-5


@pytest.mark.cuda
def test_local_stage_without_cudnn(dev):
    """With cuDNN off PyTorch's own convolutions write NCHW: the fused
    forward takes their outputs channels-last, launches ten times, and lies
    within float32 noise of the modules' chain (whose convolutions add
    their bias inside the product)."""
    torch.manual_seed(14)
    m = LocalStage().to(dev).eval()
    x = torch.rand((64, 21, 21, 3), device=dev)
    saved = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        le.reset_launch_counts()
        with torch.no_grad():
            fused = m(x)
        assert le.launch_counts()["local_epilogue"] == 10
        with torch.enable_grad():
            plain = m(x).detach()
    finally:
        torch.backends.cudnn.enabled = saved
    gap = (fused - plain).abs().max().item() / plain.abs().max().item()
    print(f"LocalStage fused vs plain without cuDNN: largest gap {gap:.3e} of the output's scale")
    assert gap < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_estimator_launches(dev, dtype):
    """Ten launches a LocalStage forward in float32, none in bfloat16."""
    from blurry_edges_tpu_torch.config import CamConfig, GridConfig, PatchConfig
    from blurry_edges_tpu_torch.eval.pipeline import make_depth_estimator
    from blurry_edges_tpu_torch.models.weights import random_modules

    mods = random_modules(torch.Generator().manual_seed(10), dev, dtype=dtype)
    forwards = []
    hook = mods.local_model.register_forward_hook(lambda *a: forwards.append(1))
    est = make_depth_estimator(mods, PatchConfig(), GridConfig(H=41, W=41), CamConfig(),
                               device=dev)
    le.reset_launch_counts()
    img = np.random.default_rng(11).uniform(0, 1, (2, 41, 41, 3)).astype(np.float32)
    est(img)
    torch.cuda.synchronize()
    hook.remove()
    assert len(forwards) >= 1
    launches = le.launch_counts()["local_epilogue"]
    assert launches == (10 * len(forwards) if dtype == torch.float32 else 0)
