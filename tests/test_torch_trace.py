"""The port's spans (``utils/trace.py``): nothing recorded without a
profiler; under one, the stages of a 41x41 estimator (published widths,
random weights), of the 587x587 path at 69x69 in 41x41 blocks, and of a
checkpointed global training step, nested as the program calls them, with
self times that add up, on the profiler's timeline as plain CPU events.
No JAX."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from blurry_edges_tpu_torch.config import CamConfig, GridConfig, PatchConfig
from blurry_edges_tpu_torch.eval import pipeline, pipeline_big
from blurry_edges_tpu_torch.models.global_stage import GlobalStage
from blurry_edges_tpu_torch.ops.dfd import DfDSolver
from blurry_edges_tpu_torch.train import global_ as tg
from blurry_edges_tpu_torch.train.optim import make_optimizer
from blurry_edges_tpu_torch.utils import trace
from blurry_edges_tpu_torch.models.weights import random_modules

H = 41
PATCH, CAM = PatchConfig(), CamConfig()
ESTIMATOR_STAGES = ("local_stage", "wedge_colors", "global_stage", "wedge_render", "fold", "unet")
# the big path's tiny geometry: 3 x 3 blocks of 41x41 over 69x69, margins of 2 patches
BIG, BLOCK, MARGIN, CHUNK = 69, 41, 2, 4
N_BLOCKS = 9


def pairs(n, size, seed=0):
    return np.random.default_rng(seed).uniform(0.0, 1.0, (n, 2, size, size, 3)).astype(np.float32)


def profiled(fn):
    """``fn()`` under a CPU profiler, the records dropped before it:
    (the profiler, the records, the summary)."""
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof, trace.records(), trace.summary()


def estimator_requests():
    """Two requests of the 41x41 pp estimator: one pair, then two pairs
    batched."""
    mods = random_modules(torch.Generator().manual_seed(0), device="cpu", unet=True)
    grid = GridConfig(H=H, W=H)
    one = pipeline.make_depth_estimator(mods, PATCH, grid, CAM, densify="pp", device="cpu")
    two = pipeline.make_batched_depth_estimator(mods, PATCH, grid, CAM, densify="pp",
                                                device="cpu")
    x = pairs(2, H)
    return lambda: (one(x[0]), two(x))


def big_request():
    """One request of the block-tiled estimator: 9 blocks in chunks of 4."""
    mods = random_modules(torch.Generator().manual_seed(1), device="cpu")
    est = pipeline_big.make_big_depth_estimator(
        mods, PATCH, GridConfig(H=BLOCK, W=BLOCK), GridConfig(H=BIG, W=BIG), CAM, MARGIN,
        block_chunk=CHUNK, device="cpu")
    x = pairs(1, BIG)[0]
    return lambda: est(x)


def train_step_call(chunks=2, device="cpu"):
    """One global training step, batch 4 in ``chunks`` checkpointed chunks."""
    torch.manual_seed(0)
    grid = GridConfig(H=H, W=H)
    model = GlobalStage(num_encoder_layers=2).to(device)
    step, _ = tg.make_step_fns(model, make_optimizer(model.parameters(), 1e-4), PATCH, grid,
                               DfDSolver.from_config(CAM, PATCH), chunks)
    rng = np.random.default_rng(11)
    B, L = 4, grid.num_tokens
    bd = np.zeros((B, H, H), np.float32)
    bd[:, ::5, :] = rng.uniform(0.75, 1.18, (B, (H + 4) // 5, H))
    batch = {"input_param": rng.normal(scale=0.3, size=(B, 2, L, 19)),
             "img_gt": rng.uniform(0, 1, (B, 2, H, H, 3)),
             "bndry_dist": rng.integers(0, 10, (B, H, H)),
             "deri": rng.uniform(0, 1, (B, 2, H - 2, H - 2, 3)), "bndry_depth": bd}
    batch = {k: torch.from_numpy(np.asarray(v, np.float32)).to(device) for k, v in batch.items()}
    gammas = torch.tensor([0.7, 0.2, 0.05, 0.1, 0.1, 0.05, 0.5], device=device)
    return lambda: float(step(batch, gammas, 3))


@pytest.fixture(scope="module")
def served():
    return profiled(estimator_requests())


@pytest.fixture(scope="module")
def big():
    return profiled(big_request())


@pytest.fixture(scope="module")
def stepped():
    return profiled(train_step_call())


def by_id(recs):
    return {r.id: r for r in recs}


def test_off_returns_the_shared_no_op_and_records_nothing():
    trace.reset()
    assert trace.span("estimator", pairs=1) is trace.OFF
    with trace.span("estimator", pairs=1) as s:
        assert s is None
    estimator_requests()()
    assert trace.records() == [] and trace.summary() == {}


def test_estimator_records_each_request_with_its_stages(served):
    _, recs, s = served
    roots = [r for r in recs if r.name == "estimator"]
    assert [r.pairs for r in roots] == [1, 2] and s["estimator"]["pairs"] == 3
    assert all(r.parent is None and r.root == r.id for r in roots)
    for root in roots:
        stages = [r.name for r in recs if r.root == root.id and r.id != root.id]
        assert sorted(stages) == sorted(ESTIMATOR_STAGES)
        assert all(r.parent == root.id for r in recs if r.root == root.id and r.id != root.id)
    assert {n: s[n]["calls"] for n in ESTIMATOR_STAGES} == {n: 2 for n in ESTIMATOR_STAGES}
    assert all(v["device_ms"] is None and v["device_self_ms"] is None for v in s.values())


def test_big_path_stitches_once_per_chunk(big):
    _, recs, s = big
    (root,) = [r for r in recs if r.name == "estimator"]
    stitches = [r for r in recs if r.name == "stitch"]
    assert len(stitches) == -(-N_BLOCKS // CHUNK)
    assert all(r.parent == root.id for r in stitches)
    assert s["local_stage"]["calls"] == s["wedge_render"]["calls"] == len(stitches)
    assert s["fold"]["calls"] == 1 and s["estimator"]["pairs"] == 1


def test_checkpointed_step_recomputes_the_loss_under_backward(stepped):
    _, recs, s = stepped
    ids = by_id(recs)
    (root,) = [r for r in recs if r.name == "train_step"]
    (bwd,) = [r for r in recs if r.name == "backward"]
    (opt,) = [r for r in recs if r.name == "optimizer"]
    assert bwd.parent == opt.parent == root.id
    losses = [r for r in recs if r.name == "loss"]
    assert len(losses) == 4                          # two chunks, each forward and recompute
    assert sorted(ids[r.parent].name for r in losses) == ["backward"] * 2 + ["train_step"] * 2
    stages = [r for r in recs if r.name == "global_stage"]
    assert sorted(ids[r.parent].name for r in stages) == ["backward"] * 2 + ["train_step"] * 2
    assert all(r.root == root.id for r in recs)
    assert s["train_step"]["calls"] == 1


@pytest.mark.parametrize("which", ["served", "big", "stepped"])
def test_self_times_add_up(which, request):
    _, recs, s = request.getfixturevalue(which)
    ids = by_id(recs)
    for r in recs:                                   # children lie inside their parent
        if r.parent is not None:
            p = ids[r.parent]
            assert p.t0 <= r.t0 <= r.t1 <= p.t1
    for v in s.values():
        assert 0.0 <= v["host_self_ms"] <= v["host_ms"]
    kids = {}
    for r in recs:
        kids.setdefault(r.parent, []).append(r)
    for r in recs:                                   # one span: duration = self + children
        inner = sum(k.t1 - k.t0 for k in kids.get(r.id, []))
        assert inner <= r.t1 - r.t0
    total = sum(v["host_self_ms"] for v in s.values())
    roots = sum(v["host_ms"] for n, v in s.items()
                if n in ("estimator", "train_step"))
    assert total == pytest.approx(roots, rel=1e-9)


def test_an_exception_closes_the_span_and_summary_is_idempotent():
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            with trace.span("estimator", pairs=1):
                with trace.span("local_stage"):
                    raise ValueError("inside")
        with trace.span("fold"):
            pass
    assert trace._STACK == []
    recs = by_id(trace.records())
    assert sorted(r.name for r in recs.values()) == ["estimator", "fold", "local_stage"]
    assert [r.parent for r in recs.values() if r.name == "fold"] == [None]
    first = trace.summary()
    assert trace.summary() == first and first["estimator"]["pairs"] == 1
    trace.reset()
    assert trace.summary() == {}


@pytest.mark.parametrize("which", ["served", "big", "stepped"])
def test_spans_are_plain_cpu_events_on_the_profiler_timeline(which, request):
    """The spans are RecordFunction ranges that are not user annotations:
    the profiler does not mirror them onto the device timeline. This pins
    the private entry points the spans use."""
    prof, recs, _ = request.getfixturevalue(which)
    names = {r.name for r in recs}
    events = [e for e in prof.events() if e.name in names]
    assert {e.name for e in events} == names
    assert len(events) == len(recs)
    for e in events:
        assert e.device_type == torch.autograd.DeviceType.CPU
        assert e.is_user_annotation is False
