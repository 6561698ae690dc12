"""The training cell's span readers on what the traced run keeps: the
stage metrics ``span.{global_stage,loss,backward,optimizer}.host_ms`` read
one eager step profiled on its own (``spans.profiled``, kept as
``eager_spans``), and the graph metrics read the replayed steps' spans
(kept as ``spans``), whatever the program's records hold when the readers
run. A tiny eager training step on the CPU stands in for the card's."""

import numpy as np
import pytest
import torch

from benchmark import spans
from benchmark.harness import load_module
from benchmark.test_benchmark_dispatch import ROOT
from blurry_edges_tpu_torch.config import CamConfig, GridConfig, PatchConfig
from blurry_edges_tpu_torch.models.global_stage import GlobalStage
from blurry_edges_tpu_torch.ops.dfd import DfDSolver
from blurry_edges_tpu_torch.train import global_ as tg
from blurry_edges_tpu_torch.train.optim import make_optimizer
from blurry_edges_tpu_torch.utils import trace

STAGES = [f"span.{s}.host_ms" for s in ("global_stage", "loss", "backward", "optimizer")]
GRAPH = ["span.graph_replay.host_ms", "host.graph_replay_pct.train"]
H = 41


def reader(name):
    return load_module(ROOT / "benchmark" / "metrics" / f"{name}.py").read


def eager_step():
    """One eager global training step at 41x41, 2 layers, batch 4 in 2
    checkpointed chunks."""
    torch.manual_seed(0)
    patch, grid = PatchConfig(), GridConfig(H=H, W=H)
    model = GlobalStage(num_encoder_layers=2)
    step, _ = tg.make_step_fns(model, make_optimizer(model.parameters(), 1e-4), patch, grid,
                               DfDSolver.from_config(CamConfig(), patch), 2)
    rng = np.random.default_rng(11)
    B, L = 4, grid.num_tokens
    bd = np.zeros((B, H, H), np.float32)
    bd[:, ::5, :] = rng.uniform(0.75, 1.18, (B, (H + 4) // 5, H))
    batch = {"input_param": rng.normal(scale=0.3, size=(B, 2, L, 19)),
             "img_gt": rng.uniform(0, 1, (B, 2, H, H, 3)),
             "bndry_dist": rng.integers(0, 10, (B, H, H)),
             "deri": rng.uniform(0, 1, (B, 2, H - 2, H - 2, 3)), "bndry_depth": bd}
    batch = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in batch.items()}
    gammas = torch.tensor([0.7, 0.2, 0.05, 0.1, 0.1, 0.05, 0.5])
    return lambda: float(step.eager(batch, gammas, 3))


@pytest.fixture(scope="module")
def eager_spans():
    return spans.profiled(eager_step())


def replays():
    """The kept spans of 3 profiled steps, all replayed graphs."""
    return {"train_step": dict(calls=3, host_ms=9.9, host_self_ms=0.3, device_ms=None,
                               device_self_ms=None, pairs=None),
            "graph_replay": dict(calls=3, host_ms=9.6, host_self_ms=9.0, device_ms=None,
                                 device_self_ms=None, pairs=None)}


def test_profiled_keeps_one_step_and_drops_the_records(eager_spans):
    assert eager_spans["train_step"]["calls"] == 1
    assert {"global_stage", "loss", "backward", "optimizer"} <= set(eager_spans)
    assert trace.records() == []


@pytest.mark.parametrize("name", STAGES)
def test_stage_readers_read_the_kept_eager_step(eager_spans, name):
    stage = name.split(".")[1]
    rec = {"spans": replays(), "eager_spans": eager_spans}
    assert reader(name)(rec) == pytest.approx(eager_spans[stage]["host_self_ms"])
    assert reader(name)(rec) > 0
    assert reader(name)({"spans": replays()}) is None      # no eager step kept, no records


def test_graph_readers_read_the_kept_replays(eager_spans):
    rec = {"spans": replays(), "eager_spans": eager_spans}
    assert reader("host.graph_replay_pct.train")(rec) == pytest.approx(100.0)
    assert reader("span.graph_replay.host_ms")(rec) == pytest.approx(3.0)


@pytest.mark.parametrize("name", GRAPH)
def test_graph_readers_ignore_the_eager_step(eager_spans, name):
    assert reader(name)({"spans": {}, "eager_spans": eager_spans}) is None
