"""The span that the bfloat16 networks add to the port's tracing
(``utils/trace.py``): under a CPU profiler a bfloat16 estimator records
``softmax_bf16`` inside each GlobalStage layer; float32 networks do not;
without a profiler nothing is recorded. And the benchmark's reading of the
casts' device time from the trace, by kernel name, over the pairs served.
No JAX."""

from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness
from blurry_edges_tpu_torch.config import CamConfig, GridConfig, PatchConfig
from blurry_edges_tpu_torch.eval import pipeline
from blurry_edges_tpu_torch.utils import trace
from blurry_edges_tpu_torch.models.weights import random_modules

ROOT = Path(__file__).resolve().parent.parent
H = 41
NEW = ("softmax_bf16",)


def estimator(dtype):
    mods = random_modules(torch.Generator().manual_seed(3), device="cpu", unet=True, dtype=dtype)
    est = pipeline.make_depth_estimator(mods, PatchConfig(), GridConfig(H=H, W=H), CamConfig(),
                                        densify="pp", device="cpu")
    return mods, est


def pair():
    return np.random.default_rng(4).uniform(0.0, 1.0, (2, H, H, 3)).astype(np.float32)


def profiled(fn):
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, trace.records(), trace.summary()


@pytest.fixture(scope="module")
def bf16_request():
    mods, est = estimator(torch.bfloat16)
    x = pair()
    plain = est(x)
    out, recs, s = profiled(lambda: est(x))
    trace.reset()
    return mods, plain, out, recs, s


def test_bf16_estimator_records_the_softmax_in_each_layer(bf16_request):
    mods, _, _, recs, s = bf16_request
    ids = {r.id: r for r in recs}
    softmaxes = [r for r in recs if r.name == "softmax_bf16"]
    assert len(softmaxes) == len(mods.global_model.encoder.layers)
    assert {ids[r.parent].name for r in softmaxes} == {"global_stage"}
    assert s["softmax_bf16"]["calls"] == len(softmaxes)


def test_profiling_leaves_the_bf16_answer_unchanged(bf16_request):
    _, plain, out, _, _ = bf16_request
    for k in ("depth_final", "confidence", "global_depth"):
        assert torch.equal(plain[k], out[k]), k


def test_float32_networks_record_none_of_them():
    _, est = estimator(torch.float32)
    _, recs, s = profiled(lambda: est(pair()))
    assert "estimator" in s and "global_stage" in s
    assert not {r.name for r in recs} & set(NEW) and not set(s) & set(NEW)
    trace.reset()


def test_bf16_estimator_without_a_profiler_records_nothing():
    trace.reset()
    _, est = estimator(torch.bfloat16)
    est(pair())
    assert trace.records() == [] and trace.summary() == {}


# kernel names as an H100 trace of the bfloat16 estimator shows them (PyTorch 2.11)
TO_BF16 = ("void at::native::vectorized_elementwise_kernel<8, at::native::bfloat16_copy_kernel_cuda("
           "at::TensorIteratorBase&)::{lambda(float)#1}, std::array<char*, 2ul> >")
TO_F32 = ("void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda("
          "at::TensorIteratorBase&)::{lambda()#3}::operator()() const::{lambda()#7}::operator()() "
          "const::{lambda(float)#1}, std::array<char*, 2ul>, 4, TrivialOffsetCalculator<1, unsigned "
          "int>, TrivialOffsetCalculator<1, unsigned int>, at::native::memory::LoadWithCast<1>, "
          "at::native::memory::StoreWithCast<1> >")
F32_COPY = ("void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<"
            "at::native::direct_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}::operator()"
            "() const::{lambda()#7}::operator()() const::{lambda(float)#1}>")
BF16_COPY = ("void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl_nocast<"
             "at::native::direct_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}::operator()"
             "() const::{lambda()#12}::operator()() const::{lambda(c10::BFloat16)#1}>")
BF16_ADD = ("void at::native::vectorized_elementwise_kernel<8, at::native::CUDAFunctor_add<"
            "c10::BFloat16>, std::array<char*, 3ul> >")


def cast_metric():
    return harness.load_module(ROOT / "benchmark/metrics/kernels.cast.ms.py")


@pytest.mark.parametrize("name, converts", [(TO_BF16, True), (TO_F32, True), (F32_COPY, False),
                                            (BF16_COPY, False), (BF16_ADD, False)],
                         ids=["to_bf16", "to_float32", "float32_copy", "bf16_copy", "bf16_add"])
def test_cast_reader_picks_the_converting_copies_by_name(name, converts):
    assert cast_metric().is_cast(name) is converts


def test_cast_reader_sums_the_conversions_over_the_profiled_pairs():
    kernels = {TO_BF16: [1e-5] * 6, TO_F32: [2e-5] * 3, F32_COPY: [1.0], BF16_ADD: [1.0]}
    rec = {"trace": {"kernels": kernels, "calls": 3}, "pairs": 8, "latencies_s": [0.04] * 8}
    assert cast_metric().read(rec) == pytest.approx(1e3 * (6e-5 + 6e-5) / 3)
    rec.update(pairs=16)                                 # two pairs a request
    assert cast_metric().read(rec) == pytest.approx(1e3 * (6e-5 + 6e-5) / 6)


@pytest.mark.parametrize("rec", [{"pairs": 8, "latencies_s": [0.04] * 8},
                                 {"trace": {"kernels": {F32_COPY: [1.0]}, "calls": 3}, "pairs": 8,
                                  "latencies_s": [0.04] * 8}],
                         ids=["untraced", "float32_only"])
def test_cast_reader_reads_nothing_without_conversions(rec):
    assert cast_metric().read(rec) is None
