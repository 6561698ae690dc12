"""The check that decides ``correct`` fails a run whose timed path is
broken underneath. Each test skips the look for a card and drives a whole
run on the CPU at a small size (the cells' widths, the program's plain
path) with one fault planted in the program, for each fault a cell can
have; a sound run of the same cell comes out correct."""

import pytest

from benchmark.faults import (altered_loss, alter_depth, depth_block, frozen_state, half_batch,
                              half_rows)
from benchmark.test_benchmark_dispatch import run, tiny_root


CASES = [("be147.serve", None), ("be147.serve", alter_depth), ("be147.serve", depth_block),
         ("be147.serve-x4", None), ("be147.serve-x4", alter_depth), ("be147.serve-x4", depth_block),
         ("be147.serve-x4", half_batch),
         ("be587.serve", None), ("be587.serve", alter_depth), ("be587.serve", depth_block),
         ("be147.train", frozen_state), ("be147.train", half_rows),
         ("be147.train", altered_loss)]


@pytest.mark.parametrize("cell,fault", CASES,
                         ids=[f"{c}-{f.__name__ if f else 'sound'}" for c, f in CASES])
def test_fault_makes_the_run_incorrect(tmp_path, capsys, monkeypatch, cell, fault):
    root = tiny_root(tmp_path)
    if fault is not None:
        fault(monkeypatch)
    out = run(root, cell, False, capsys=capsys)
    assert out["correct"] is (fault is None), out["checks"]


def test_sound_training_run_reads_float32_noise(tmp_path, capsys):
    """The training cell's sound run at this size: its numbers are float32
    noise, which at 121 tokens is wider than at the cell's 4,096 (the
    float32 reference's own change lies up to 1e-2 from float64's at this
    size), and far under every fault's."""
    out = run(tiny_root(tmp_path), "be147.train", False, capsys=capsys)
    v = {k: c["value"] for k, c in out["checks"].items()}
    assert v["loss1_rel"] < 1e-6 and v["grad_gap"] < 1e-2 and v["change_gap"] < 5e-2, v
