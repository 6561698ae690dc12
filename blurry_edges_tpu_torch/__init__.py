"""PyTorch/CUDA port of blurry_edges_tpu for NVIDIA Hopper (H100).

The JAX package's subpackages (``ops``, ``models``, ``data``, ``eval``,
``train``, ``utils``, ``parallel``), with the weight loaders under
``models`` (``models/weights.py``) and the image reader under ``data``
(``data/imageio.py``), and the same layouts at the public functions (NHWC
images, ``(..., R, R, 3)`` patches). Imports point down one layer order,
bottom to top: ``config`` and ``utils``, ``parallel``, ``ops`` (with
``csrc/``), ``models``, ``data``, ``eval``, ``train``, ``cli``
(``tests/test_torch_pipeline.py::test_port_imports_point_down_the_layers``).
Every TPU kernel of the JAX package (the two Pallas wedge kernels and the
library flash attention's forward and two backward kernels) is hand-written
CUDA C++ under ``csrc/``, built with ``nvcc`` at first use
(``ops/_build.py``). Imports torch only.
"""
