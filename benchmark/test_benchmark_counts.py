"""The yardstick's counts: kernel operations and bytes worked by hand at the
cells' shapes, the least times, and the networks' FLOPs a pair."""

import pytest

from benchmark.counts import kernels as K
from benchmark.counts import models as M
from benchmark.counts.peaks import HBM_BYTES_PER_S, ops_per_s
from benchmark.harness import load_json
from benchmark.test_benchmark_dispatch import ROOT

R, L = 21, 64 * 64


def test_wedge_colors_one_pair():
    ops, nbytes = K.wedge_colors(P=2 * L, R=R)
    assert ops == 8192 * 441 * 150 == 541_900_800
    # 10 params + 1,323 pixels in, 9 colours out, float32, each once
    assert nbytes == 8192 * 1342 * 4 == 43_974_656
    assert K.least_seconds("wedge_colors", {"P": 2 * L, "R": R}) == pytest.approx(
        43_974_656 / 3.35e12)


def test_wedge_render_one_pair_and_a_587_chunk():
    ops, nbytes = K.wedge_render(B=1, L=L, R=R)
    assert ops == 4096 * 441 * 420
    # 8 + 4 in a patch; 2 x 441 x 3 pixels in; 441 x (6 + 3 + 3 + 1 + 1 + 1) out
    assert nbytes == 4096 * (12 + 2646 + 6615) * 4 == 151_928_832
    assert K.wedge_render(B=4, L=L, R=R)[1] == 4 * nbytes


def test_flash_counts_the_mathematics_not_3xtf32():
    shape = dict(B=2, H=8, L=4096, D=16)
    for k in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        ops, _ = K.KERNELS[k](**shape)
        assert ops == 4 * 2 * 8 * 4096 ** 2 * 16 == 17_179_869_184
    assert K.flash_fwd(**shape)[1] == (4 * 2 * 8 * 4096 * 16 + 2 * 8 * 4096) * 4
    assert K.flash_bwd_dkv(**shape)[1] == (6 * 1_048_576 + 2 * 65_536) * 4
    assert K.flash_bwd_dq(**shape)[1] == (5 * 1_048_576 + 2 * 65_536) * 4
    # operations bind: 34.7 us at 495 TFLOP/s against 2.5 us of bytes
    assert K.least_seconds("flash_fwd", shape) == pytest.approx(17_179_869_184 / 495e12)
    assert K.least_seconds("flash_fwd", shape, "bfloat16") == pytest.approx(17_179_869_184 / 989e12)


def test_peaks():
    assert ops_per_s("float32") == 495e12 and HBM_BYTES_PER_S == 3.35e12


def test_networks_flops_match_the_smoke_readings():
    """chip_smoke.py's counts: 3.1762 / 0.0774 / 0.0309 TFLOP a pair."""
    assert M.local_stage_flops(8192, 21) / 1e12 == pytest.approx(3.1762, abs=5e-5)
    assert M.global_stage_flops(4096) / 1e12 == pytest.approx(0.0774, abs=5e-5)
    assert M.unet_flops(147, 147) / 1e12 == pytest.approx(0.0309, abs=5e-5)


def test_flops_per_pair_and_step_of_the_configurations():
    c147 = load_json(ROOT / "benchmark/configs/be147.json")
    c587 = load_json(ROOT / "benchmark/configs/be587.json")
    core = M.local_stage_flops(8192, 21) + M.global_stage_flops(4096)
    assert M.serve_flops_per_pair(c147) == core + M.unet_flops(147, 147)
    assert M.serve_flops_per_pair(c587) == 36 * core
    assert M.train_flops_per_step(c147, 8) == 3 * 8 * M.global_stage_flops(4096)
