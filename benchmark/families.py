"""Kernel families: every device operation of a traced window falls in
exactly one, by its name in the profiler's trace. The family of a name is
the first of ``FAMILIES`` one of whose patterns the name holds, compared
in lower case; a name that holds none is ``other`` (LayerNorm,
concatenations, ``memcpy`` kernels, memory sets).

The order matters where a name holds two families' patterns: cuBLAS's
``splitKreduce_kernel`` holds a reduction's ``reduce_kernel``."""

from __future__ import annotations

FAMILIES = (
    # the three hand-written flash-attention kernels (ops/flash_attention.py)
    ("flash", ("flash_fwd_kernel", "flash_bwd_dkv_kernel", "flash_bwd_dq_kernel")),
    # the foreach kernels of torch.optim's AdamW (train/optim.py)
    ("optimizer", ("multi_tensor_apply_kernel",)),
    # F.unfold and F.fold and their backwards (ops/patchify.py): im2col_kernel,
    # col2im_kernel, col2im_batched_kernel
    ("unfold", ("im2col", "col2im")),
    # cuBLAS and CUTLASS matrix products and cuBLAS's split-K reduction
    ("gemm", ("gemm", "gemv", "splitkreduce")),
    # PyTorch's elementwise, vectorized, unrolled and random-draw kernels,
    # its reductions and its softmax
    ("elementwise", ("elementwise", "reduce_kernel", "softmax")),
)
OTHER = "other"


def family(name: str) -> str:
    low = name.lower()
    for fam, patterns in FAMILIES:
        if any(p in low for p in patterns):
            return fam
    return OTHER


def ms_per_call(rec: dict, fam: str):
    """Device milliseconds of a family (or ``other``) over the profiled
    calls (requests or steps); None without a trace or where none of its
    kernels ran."""
    t = rec.get("trace")
    if not t:
        return None
    spent = [d for name, ds in t["kernels"].items() if family(name) == fam for d in ds]
    return 1e3 * sum(spent) / t["calls"] if spent else None
