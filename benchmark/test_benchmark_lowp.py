"""The bfloat16 serving cell on the CPU at 41x41 (the configuration's widths,
the program's plain path): it runs through the harness's dispatch and reads
correct; the folded depth 1% off, one block of it 1% off, and a rounding
point of either network moved (the softmax or Smish's sigmoid rounded once,
as torch's own would) each make it incorrect; the fp8 control's numbers
fail one of its limits; the unjudged end-to-end numbers are recorded
beside the judged ones; its plain reference imports nothing of the program
or of JAX."""

import json
import time

import pytest
import torch

from benchmark import harness
from benchmark.faults import alter_depth, depth_block
from benchmark.test_benchmark_dispatch import ROOT, run, tiny_root
from benchmark.test_benchmark_imports import top_level_imports

CELL = "be147-bf16.serve"


def tiny_lowp_root(tmp_path):
    """``tiny_root`` with the bfloat16 cell pointed at a 41x41 copy of its
    configuration."""
    root = tiny_root(tmp_path)
    c = harness.load_json(ROOT / "benchmark/configs/be147-bf16.json")
    c.update(img_size=41)
    c["scene"]["n_shapes"] = 4
    (root / "benchmark/configs/tiny41-bf16.json").write_text(json.dumps(c))
    m = harness.load_json(root / "BENCHMARK.json")
    for w in m["workloads"]:
        if w["name"] == CELL:
            w["config"] = "tiny41-bf16"
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    return root


def softmax_rounded_once(monkeypatch):
    """The global stage's softmax rounded to bfloat16 once, at its result."""
    from blurry_edges_tpu_torch.models import global_stage

    monkeypatch.setattr(global_stage, "softmax_bf16", lambda x: torch.softmax(x, dim=-1))


def sigmoid_rounded_once(monkeypatch):
    """The local stage's Smish with its sigmoid rounded to bfloat16 once."""
    from blurry_edges_tpu_torch.models import local_stage

    monkeypatch.setattr(local_stage, "smish",
                        lambda x: x * torch.tanh(torch.log1p(torch.sigmoid(x))))


# each fault with the check that must catch it
FAULTS = {"alter_depth": (alter_depth, "held.depth_rel_p50"),
          "depth_block": (depth_block, "held.depth_off_share"),
          "softmax_rounded_once": (softmax_rounded_once, "global_gap"),
          "sigmoid_rounded_once": (sigmoid_rounded_once, "local_gap")}


@pytest.mark.parametrize("fault", [None, *FAULTS])
def test_cell_runs_and_each_fault_makes_it_incorrect(tmp_path, capsys, monkeypatch, fault):
    root = tiny_lowp_root(tmp_path)
    if fault is not None:
        FAULTS[fault][0](monkeypatch)
    out = run(root, CELL, False, capsys=capsys)
    assert out["correct"] is (fault is None), out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    if fault is None:
        # the networks and the chain held alone agree with the reference to the bit
        assert all(c["value"] == 0.0 for c in out["checks"].values()), out["checks"]
    else:
        c = out["checks"][FAULTS[fault][1]]
        assert c["value"] > c["limit"], out["checks"]
    m = harness.load_json(root / "BENCHMARK.json")
    assert set(out["metrics"]) == {e["name"] for e in harness.metrics_for(m, CELL, False)}


def test_unjudged_numbers_are_recorded(tmp_path, capsys):
    root = tiny_lowp_root(tmp_path)
    rc = harness.run_cell(root, CELL, 2 ** 31 + 7, 0.5, False, time.perf_counter(),
                          need_card=False, device="cpu")
    assert rc == 0
    cap = capsys.readouterr()
    (line,) = [ln for ln in cap.err.splitlines() if ln.startswith("numbers: ")]
    numbers = json.loads(line[len("numbers: "):])
    judged = set(harness.load_json(root / f"benchmark/limits/{CELL}.json")["limits"])
    end_to_end = {"conf_mean_abs", "depth_rel_p50", "depth_off_share", "densify_gap"}
    assert judged | end_to_end | {f"float32.{k}" for k in end_to_end} == set(numbers)
    assert set(json.loads(cap.out.strip().splitlines()[-1])["checks"]) == judged
    assert numbers["float32.conf_mean_abs"] > 0.0        # bf16 is not float32


def test_control_fails_a_limit(tmp_path):
    root = tiny_lowp_root(tmp_path)
    kind, ctx = harness.context(root, harness.load_json(root / "BENCHMARK.json"), CELL,
                                2 ** 31 + 991, 0.5, False, time.perf_counter(),
                                torch.device("cpu"))
    numbers = kind.control(ctx)
    failed = {k for k, v in ctx.limits.items() if numbers[k] > v}
    assert {"local_gap", "global_gap", "densify_gap"} <= failed, (numbers, ctx.limits)


def test_lowp_reference_imports_nothing_of_the_program_or_jax():
    names = top_level_imports(ROOT / "benchmark/reference/models_lowp.py")
    assert not names & (set(harness.FORBIDDEN) | {"blurry_edges_tpu_torch", "benchmark"})
