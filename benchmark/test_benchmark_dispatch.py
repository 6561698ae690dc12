"""The harness finds cells, configurations, traffic kinds and metrics by
their names in files, and runs them: a throwaway cell, configuration,
traffic mix, kind and metric added as files in a temporary checkout go
through the harness's dispatch, on the CPU (the program's plain path)."""

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parent.parent


def tiny_root(tmp_path: Path) -> Path:
    """A checkout with the benchmark's files and BENCHMARK.json, its cells
    pointed at 41x41 and 69x69 configurations (the same widths)."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "test_*"))
    m = harness.load_json(ROOT / "BENCHMARK.json")
    c = harness.load_json(ROOT / "benchmark/configs/be147.json")
    c.update(img_size=41)
    c["train"]["n_train"] = 48
    c["scene"]["n_shapes"] = 4
    (tmp_path / "benchmark/configs/tiny41.json").write_text(json.dumps(c))
    b = harness.load_json(ROOT / "benchmark/configs/be587.json")
    b.update(img_size=69, block=41, n_margin_patch=2, n_blocks=9)
    b["scene"]["n_shapes"] = 6
    (tmp_path / "benchmark/configs/tiny69.json").write_text(json.dumps(b))
    for w in m["workloads"]:
        w["config"] = "tiny41" if w["config"] == "be147" else "tiny69"
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    return tmp_path


def run(root: Path, cell: str, trace: bool, seed: int = 2 ** 31 + 7, capsys=None) -> dict:
    rc = harness.run_cell(root, cell, seed, 0.5, trace, time.perf_counter(),
                          need_card=False, device="cpu")
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_new_cell_config_kind_and_metric_from_files(tmp_path, capsys):
    root = tiny_root(tmp_path)
    (root / "benchmark/kinds/echo.py").write_text(
        "def run(ctx):\n"
        "    n = ctx.traffic['n'] * ctx.config['factor']\n"
        "    return dict(setup_s=0.5, n=n, attempted=n, failed=0, correct=True,\n"
        "                device={'platform': 'cpu', 'kind': 'cpu', 'count': 1,\n"
        "                        'memory_peak_bytes': 0},\n"
        "                checks={'gap': {'value': 0.0, 'limit': 1.0}})\n")
    (root / "benchmark/configs/toy.json").write_text(json.dumps({"factor": 3}))
    (root / "benchmark/traffic/echo-2.json").write_text(json.dumps({"kind": "echo", "n": 2}))
    (root / "benchmark/limits/toy.echo.json").write_text(json.dumps({"limits": {}}))
    (root / "benchmark/metrics/things.py").write_text("def read(rec):\n    return rec['n']\n")
    (root / "benchmark/metrics/nothing.py").write_text("def read(rec):\n    return None\n")
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["workloads"].append({"name": "toy.echo", "config": "toy", "traffic": "echo-2", "chips": 1,
                           "why": "a throwaway cell"})
    m["end_to_end"].append({"name": "things", "unit": "1", "better": "higher", "bound": 0.1,
                            "source": "host_clock", "workloads": ["toy.echo"]})
    m["per_layer"].append({"name": "nothing", "unit": "%", "better": "higher",
                           "source": "device_trace", "layer": "device", "moves": "things"})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    out = run(root, "toy.echo", False, capsys=capsys)
    assert out["correct"] and out["attempted"] == 6
    assert out["metrics"] == {"things": {"value": 6.0, "unit": "1"},
                              "setup_s": {"value": 0.5, "unit": "s"}}
    assert list(out)[-1] == "checks"
    traced = run(root, "toy.echo", True, capsys=capsys)
    assert traced["metrics"] == {}            # a reader that finds nothing is left out


@pytest.mark.parametrize("cell", ["be147.serve", "be147.serve-x4", "be587.serve", "be147.train"])
def test_each_cell_runs_through_the_dispatch_on_the_cpu(tmp_path, capsys, cell):
    """Every cell's run end to end at a small size. The training cell's
    numbers at 121 tokens are float32 noise wider than its limits, set at
    4,096 (test_benchmark_faults.py holds them), so only the serve cells
    are held to ``correct`` here."""
    root = tiny_root(tmp_path)
    out = run(root, cell, False, capsys=capsys)
    assert out["correct"] or cell == "be147.train", out
    m = harness.load_json(root / "BENCHMARK.json")
    assert set(out["metrics"]) == {e["name"] for e in harness.metrics_for(m, cell, False)}
    assert out["failed"] == 0 and out["attempted"] >= 1


def test_metrics_for_selects_by_cell():
    m = harness.load_json(ROOT / "BENCHMARK.json")
    e2e = {x["name"] for x in harness.metrics_for(m, "be147.train", False)}
    assert e2e == {"train_step_ms", "setup_s"}
    layer = {x["name"] for x in harness.metrics_for(m, "be587.serve", True)}
    assert "span.unet.ms" not in layer and "mfu.serve" in layer and "mfu.train" not in layer
    for x in m["per_layer"]:                       # each lists only cells reporting its metric
        reporting = {c for c in x["workloads"]
                     if x["moves"] in {e["name"] for e in harness.metrics_for(m, c, False)}}
        assert reporting == set(x["workloads"])


def test_no_card_means_no_result(tmp_path):
    """Without a CUDA card the command exits non-zero and prints nothing."""
    p = subprocess.run([sys.executable, str(ROOT / "benchmark/run.py"), "--workload",
                        "be147.serve", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=120, cwd=tmp_path)
    if p.returncode == 0:
        pytest.skip("a CUDA card is present")
    assert p.stdout == ""


def test_run_py_names_no_cell_config_traffic_or_metric():
    m = harness.load_json(ROOT / "BENCHMARK.json")
    names = ([w["name"] for w in m["workloads"]] + [c["name"] for c in m["configs"]]
             + [w["traffic"] for w in m["workloads"]]
             + [x["name"] for x in m["end_to_end"] + m["per_layer"]])
    for f in ("run.py", "harness.py"):
        text = (ROOT / "benchmark" / f).read_text()
        assert not [n for n in names if n in text], f
