"""Device milliseconds a step of the cuBLAS and CUTLASS matrix products
(``families.py``), in the profiled steps' trace: the GlobalStage's linear
layers, forward, recompute under checkpointing and backward."""

from benchmark.families import ms_per_call


def read(rec):
    return ms_per_call(rec, "gemm")
