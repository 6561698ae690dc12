"""The training cell's device time by kernel family (``families.py`` and
the ``kernels.*.ms.train`` readers) on a synthetic trace whose operations
are named as the H100's profiler names them, and the manifest's per-layer
metrics against the reader files under ``metrics/``."""

import pytest

from benchmark import families
from benchmark.harness import load_json, load_module
from benchmark.test_benchmark_dispatch import ROOT

METRICS = ROOT / "benchmark" / "metrics"
READERS = {f: f"kernels.{f}.ms.train" for f, _ in families.FAMILIES}
NAMES = list(READERS) + [families.OTHER]

# names as the H100's trace of a training step gives them (the softmax's from a
# serving request's), each with its family
NAMED = {
    "(anonymous namespace)::flash_fwd_kernel(float const*, float const*, float const*, "
    "float*, float*, int, float)": "flash",
    "(anonymous namespace)::flash_bwd_dkv_kernel(float const*, float const*, float "
    "const*, float const*, float const*, float const*, float*, float*, int, float)": "flash",
    "(anonymous namespace)::flash_bwd_dq_kernel(float const*, float const*, float "
    "const*, float const*, float const*, float const*, float*, int, float)": "flash",
    "void at::native::(anonymous namespace)::multi_tensor_apply_"
    "kernel<at::native::(anonymous namespace)::TensorListMetadata<2>, "
    "at::native::(anonymous namespace)::TernaryOpScalarFunctor<float, 2, 2, 0>, "
    "at::native::LerpFunctor<float>, float>(at::native::(anonymous "
    "namespace)::TensorListMetadata<2>, at::native::(anonymous "
    "namespace)::TernaryOpScalarFunctor<float, 2, 2, 0>, "
    "at::native::LerpFunctor<float>, float)": "optimizer",
    "void at::native::im2col_kernel<float>(long, float const*, long, long, long, long, "
    "long, long, long, long, long, long, long, long, float*)": "unfold",
    "void at::native::col2im_batched_kernel<float>(long, float const*, long, long, "
    "long, long, long, long, long, long, long, long, long, long, long, long, float*, "
    "long)": "unfold",
    "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize64x64x8_stage3_warpsize1x4x1_ffma_"
    "aligna4_alignc4_execute_kernel__5x_cublas": "gemm",
    "void cutlass::Kernel2<cutlass_80_simt_sgemm_128x64_8x5_nt_align1>(cutlass_80_simt_"
    "sgemm_128x64_8x5_nt_align1::Params)": "gemm",
    "void cublasLt::splitKreduce_kernel<32, 16, int, float, float, float, float, "
    "false, float, float, float, true, false, false, "
    "false>(cublasLt::cublasSplitKParams<float>, float const*, float const*, float*, "
    "float*, float const*, float const*, float const*, float const*, float*, void*, "
    "long, float*, int*, float*, float*, float const*, float const*, float const*, "
    "float const*, float const*)": "gemm",
    "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_"
    "add<float>, std::array<char*, 3ul> >(int, at::native::CUDAFunctor_add<float>, "
    "std::array<char*, 3ul>)": "elementwise",
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
    "at::native::func_wrapper_t<float, at::native::sum_functor<float, float, "
    "float>::operator()(at::TensorIterator&)::{lambda(float, float)#1}>, unsigned int, "
    "float, 4, 4> >(at::native::ReduceOp<float, at::native::func_wrapper_t<float, "
    "at::native::sum_functor<float, float, "
    "float>::operator()(at::TensorIterator&)::{lambda(float, float)#1}>, unsigned int, "
    "float, 4, 4>)": "elementwise",
    "void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<float, "
    "float, false>(int, float, float const*, float const*, float const*, float*, "
    "float*, float*)": "other",
    "void at::native::(anonymous namespace)::cunn_SoftMaxForwardReg<float, float, "
    "float, at::native::(anonymous namespace)::SoftMaxForwardEpilogue, long, "
    "4>(float*, float const*, long)": "elementwise",
    "memcpy128": "other",
    "Memset (Unknown)": "other",
    "void at::native::(anonymous namespace)::CatArrayBatchedCopy_"
    "vectorized<at::native::(anonymous namespace)::OpaqueType<4u>, unsigned int, 1, "
    "128, 1, 16, 4>(char*, at::native::(anonymous "
    "namespace)::CatArrInputTensorMetadata<at::native::(anonymous "
    "namespace)::OpaqueType<4u>, unsigned int, 128, 1>, at::native::(anonymous "
    "namespace)::TensorSizeStride<unsigned int, 4u>, int, unsigned int)": "other",
}


def trace(calls: int = 3) -> dict:
    """A trace of ``calls`` steps: the k-th name ran k + 1 times a step for
    k + 1 milliseconds each."""
    kernels = {n: [1e-3 * (k + 1)] * ((k + 1) * calls) for k, n in enumerate(NAMED)}
    return {"kernels": kernels, "calls": calls,
            "device_op_count": sum(len(d) for d in kernels.values())}


def reader(name: str):
    return load_module(METRICS / f"{name}.py").read


@pytest.mark.parametrize("name", list(NAMED), ids=lambda n: n[:40])
def test_each_name_falls_in_exactly_one_family(name):
    assert families.family(name) == NAMED[name]


def test_the_order_decides_between_two_families():
    """cuBLAS's split-K reduction holds a reduction's pattern too."""
    (name,) = [n for n in NAMED if "splitKreduce" in n]
    assert "reduce_kernel" in name.lower() and families.family(name) == "gemm"


def test_families_and_other_sum_to_the_trace():
    t = trace()
    rec = {"trace": t}
    read = {f: reader(READERS[f])(rec) for f in READERS}
    other = families.ms_per_call(rec, families.OTHER)
    total = sum(sum(d) for d in t["kernels"].values())
    assert sum(read.values()) + other == pytest.approx(1e3 * total / t["calls"], rel=1e-12)
    for f in NAMES:
        want = sum((k + 1) ** 2 for k, n in enumerate(NAMED) if NAMED[n] == f)
        assert families.ms_per_call(rec, f) == pytest.approx(want)


@pytest.mark.parametrize("family", list(READERS))
def test_readers_without_a_trace_or_a_kernel_return_none(family):
    read = reader(READERS[family])
    assert read({}) is None and read({"trace": None}) is None
    others = {n: d for n, d in trace()["kernels"].items() if NAMED[n] != family}
    assert read({"trace": {"kernels": others, "calls": 3}}) is None


def test_ops_per_step_counts_every_operation():
    t = trace()
    assert reader("device.ops_per_step.train")({"trace": t}) == t["device_op_count"] / 3
    assert reader("device.ops_per_step.train")({}) is None


def test_every_metric_has_a_reader_and_every_reader_a_metric():
    m = load_json(ROOT / "BENCHMARK.json")
    declared = {x["name"] for x in m["end_to_end"] + m["per_layer"]}
    files = {p.name[:-len(".py")] for p in METRICS.glob("*.py")}
    assert declared == files


def test_the_family_metrics_are_declared_for_the_training_cell():
    m = load_json(ROOT / "BENCHMARK.json")
    for f, name in READERS.items():
        (x,) = [e for e in m["per_layer"] if e["name"] == name]
        assert (x["unit"], x["better"], x["source"], x["moves"], x["workloads"]) == (
            "ms", "lower", "device_trace", "train_step_ms", ["be147.train"])
