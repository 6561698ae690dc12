"""The control of each cell, at the cell's own size on the card: the
reference in TF32 (the precision below the configuration's float32 with
TF32 off) put in the program's place must fail one of the cell's limits.
Run on the card with ``python -m pytest -m cuda benchmark/test_benchmark_control.py``;
skips without one."""

import time

import pytest
import torch

from benchmark import harness
from benchmark.test_benchmark_dispatch import ROOT

CELLS = [w["name"] for w in harness.load_json(ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_limit(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    kind, ctx = harness.context(ROOT, harness.load_json(ROOT / "BENCHMARK.json"), cell,
                                2 ** 31 + 991, 1.0, False, time.perf_counter(),
                                torch.device("cuda"))
    numbers = kind.control(ctx)
    assert any(numbers[k] > v for k, v in ctx.limits.items()), (numbers, ctx.limits)
