"""PyTorch/CUDA port of blurry_edges_tpu for NVIDIA Hopper (H100).

Same subpackage layout as the JAX package (``ops``, ``models``, ``train``,
``eval``, ``utils``), same layouts at the public functions (NHWC images,
``(..., R, R, 3)`` patches). Every TPU kernel of the JAX package (the two
Pallas wedge kernels and the library flash attention's forward and two
backward kernels) is hand-written CUDA C++ under ``csrc/``, built with
``nvcc`` at first use (``ops/_build.py``). Imports torch only.
"""
