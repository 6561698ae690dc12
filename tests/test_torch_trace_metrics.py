"""The benchmark's readers of the program's spans
(``benchmark/metrics/span.*.py``): a value after profiled tiny requests and
steps, None with no spans, and each metric listed only in cells that
report the end-to-end metric it moves. On the CPU no span has device
times: the serve readers, which read device self times, return None on the
CPU's summary, and are shown the host times in the device times' place to
check what they select and divide."""

import math
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness
from blurry_edges_tpu_torch.config import CamConfig, GridConfig, PatchConfig
from blurry_edges_tpu_torch.eval import pipeline
from blurry_edges_tpu_torch.utils import trace
from blurry_edges_tpu_torch.models.weights import random_modules
from tests.test_torch_trace import big_request, estimator_requests, profiled, train_step_call

ROOT = Path(__file__).resolve().parent.parent
MANIFEST = harness.load_json(ROOT / "BENCHMARK.json")
SPAN_METRICS = [m for m in MANIFEST["per_layer"] if m["source"] == "program_span"
                and m["name"].startswith("span.")]
SERVE = [m["name"] for m in SPAN_METRICS if m["moves"] == "pairs_per_s"]
# recorded only around the replay of a CUDA graph, which the CPU never runs
GRAPH = ["span.graph_replay.host_ms", "host.graph_replay_pct.train"]
TRAIN = [m["name"] for m in SPAN_METRICS
         if m["moves"] == "train_step_ms" and m["name"] not in GRAPH]


def reader(name):
    return harness.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py").read


def bf16_request():
    """One 41x41 request of the estimator with bfloat16 networks, whose
    softmax has a span of its own."""
    mods = random_modules(torch.Generator().manual_seed(2), device="cpu", unet=True,
                          dtype=torch.bfloat16)
    est = pipeline.make_depth_estimator(mods, PatchConfig(), GridConfig(H=41, W=41), CamConfig(),
                                        densify="pp", device="cpu")
    x = np.random.default_rng(5).uniform(0.0, 1.0, (2, 41, 41, 3)).astype(np.float32)
    return lambda: est(x)


@pytest.fixture(scope="module")
def spans():
    """The summary of two 41x41 requests, one 69x69 block-tiled request, one
    checkpointed training step and one 41x41 request in bfloat16, all
    profiled at once."""
    fns = [estimator_requests(), big_request(), train_step_call(), bf16_request()]
    profiled(lambda: [f() for f in fns])
    yield trace.summary()
    trace.reset()


def with_host_as_device(summary):
    return {n: dict(v, device_ms=v["host_ms"], device_self_ms=v["host_self_ms"])
            for n, v in summary.items()}


def test_the_ten_span_metrics_are_declared():
    """The ten of the float32 cells, and the bfloat16 cell's softmax."""
    assert len(SERVE) == 6 + 1 and len(TRAIN) == 4
    assert "span.softmax_bf16.ms" in SERVE
    for m in SPAN_METRICS:
        assert (m["unit"], m["better"]) == ("ms", "lower")
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()


@pytest.mark.parametrize("name", TRAIN)
def test_train_readers_read_host_self_time_a_step(spans, name, monkeypatch):
    monkeypatch.setattr(trace, "summary", lambda: spans)
    value = reader(name)({})
    assert value is not None and math.isfinite(value) and value > 0


@pytest.mark.parametrize("name", SERVE)
def test_serve_readers_read_device_self_time_a_pair(spans, name, monkeypatch):
    monkeypatch.setattr(trace, "summary", lambda: spans)
    assert reader(name)({}) is None                  # the CPU recorded no device time
    monkeypatch.setattr(trace, "summary", lambda: with_host_as_device(spans))
    value = reader(name)({})
    assert value is not None and math.isfinite(value) and value > 0


def test_serve_readers_divide_by_the_pairs_served(spans, monkeypatch):
    s = with_host_as_device(spans)
    monkeypatch.setattr(trace, "summary", lambda: s)
    pairs = s["estimator"]["pairs"]
    assert pairs == 5
    assert reader("span.wedge.ms")({}) == pytest.approx(
        (s["wedge_colors"]["host_self_ms"] + s["wedge_render"]["host_self_ms"]) / pairs)
    assert reader("span.stitch_fold.ms")({}) == pytest.approx(
        (s["stitch"]["host_self_ms"] + s["fold"]["host_self_ms"]) / pairs)


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_readers_without_spans_return_none(name):
    trace.reset()
    assert reader(name)({}) is None


@pytest.mark.parametrize("name", [m["name"] for m in SPAN_METRICS])
def test_each_lists_only_cells_that_report_what_it_moves(name):
    m = next(x for x in SPAN_METRICS if x["name"] == name)
    assert m["workloads"]
    for cell in m["workloads"]:
        e2e = {e["name"] for e in harness.metrics_for(MANIFEST, cell, False)}
        assert m["moves"] in e2e
        assert name in {x["name"] for x in harness.metrics_for(MANIFEST, cell, True)}


def replayed_steps():
    """A fake summary of 4 profiled steps, 3 of them replayed graphs."""
    return {"train_step": dict(calls=4, host_ms=40.0, host_self_ms=30.0, device_ms=None,
                               device_self_ms=None, pairs=None),
            "graph_replay": dict(calls=3, host_ms=9.0, host_self_ms=7.5, device_ms=None,
                                 device_self_ms=None, pairs=None)}


def test_graph_readers_read_replays_a_step(monkeypatch):
    monkeypatch.setattr(trace, "summary", replayed_steps)
    assert reader("host.graph_replay_pct.train")({}) == pytest.approx(75.0)
    assert reader("span.graph_replay.host_ms")({}) == pytest.approx(7.5 / 4)


@pytest.mark.parametrize("name", GRAPH)
def test_graph_readers_without_replays_return_none(name, spans, monkeypatch):
    trace.reset()
    assert reader(name)({}) is None
    monkeypatch.setattr(trace, "summary", lambda: spans)   # eager CPU steps only
    assert "train_step" in spans and "graph_replay" not in spans
    assert reader(name)({}) is None


@pytest.mark.parametrize("name", GRAPH)
def test_graph_readers_are_declared_for_the_training_cell(name):
    m = next(x for x in MANIFEST["per_layer"] if x["name"] == name)
    assert (m["source"], m["moves"], m["workloads"]) == ("program_span", "train_step_ms",
                                                        ["be147.train"])
    assert m["layer"] == "host: Python dispatch and kernel launches"
