"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, without
sparsity, at its 700 W limit).

A float32 configuration is held to the TF32 tensor-core rate: TF32 is the
finest format whose products the chip makes on its tensor cores, and every
float32-grade method (plain float32 on the CUDA cores at 67 TFLOP/s, or
3xTF32's three tensor-core products) costs at least one such product a
multiply, so no correct float32 implementation can pass 100%. A bfloat16
configuration is held to the bf16 rate."""

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 495e12, "bfloat16": 989e12}


def ops_per_s(dtype: str) -> float:
    return PEAK_OPS_PER_S[dtype]
