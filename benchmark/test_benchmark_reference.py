"""The plain reference against the program's plain CPU path at small sizes
(the program's kernels run their plain versions on the CPU): the
estimator's served depth and confidence, the block-tiled path's stitch,
the training loss terms, the global stage's training forward with its
keyed dropout, and the trainer's first steps."""

import math

import numpy as np
import pytest
import torch

from benchmark import judge
from benchmark.harness import load_json
from benchmark.inputs.pairs import make_pairs
from benchmark.inputs.trainset import make_trainset
from benchmark.inputs.weights import make_weights
from benchmark.kinds import serve, train
from benchmark.reference import models as ref
from benchmark.reference import train as rt
from benchmark.reference import wedge as W
from benchmark.reference.estimator import Estimator
from benchmark.reference.keying import fold_in
from benchmark.test_benchmark_dispatch import ROOT

CPU = torch.device("cpu")
C147 = load_json(ROOT / "benchmark/configs/be147.json")
C587 = load_json(ROOT / "benchmark/configs/be587.json")


def small(cfg, **kw):
    c = dict(cfg)
    c.update(kw)
    return c


@pytest.mark.parametrize("densify", ["pp", "w", "threshold"])
def test_estimator_41(densify):
    cfg = small(C147, img_size=41, densify=densify)
    w = make_weights(21, CPU)
    pair = make_pairs(22, 1, 41, cfg, CPU)
    fn, _ = serve.program_estimator(cfg, w, 1, CPU)
    got = {k: v[0].numpy() for k, v in fn(pair[0].numpy()).items() if k in serve.SERVED}
    reference = Estimator({k: ref.build(k, w[k], CPU) for k in w}, cfg)
    want = reference(pair)[0]
    n = serve.judge_pair(reference, got, want, CPU)
    assert n["conf_mean_abs"] == 0.0 and n["depth_rel_p50"] < 1e-6 and n["densify_gap"] < 1e-6, n
    np.testing.assert_allclose(got["depth_final"], want["depth_final"], rtol=1e-4, atol=1e-6)


def test_big_path_stitch_69():
    cfg = small(C587, img_size=69, block=41, n_margin_patch=2, n_blocks=9)
    w = make_weights(23, CPU, ("local", "global"))
    pair = make_pairs(24, 1, 69, cfg, CPU)
    fn, _ = serve.program_estimator(cfg, w, 1, CPU)
    got = {k: v[0].numpy() for k, v in fn(pair[0].numpy()).items() if k in serve.SERVED}
    reference = Estimator({k: ref.build(k, w[k], CPU) for k in w}, cfg, group=4)
    n = serve.judge_pair(reference, got, reference(pair)[0], CPU)
    assert n["conf_mean_abs"] < 1e-5 and n["depth_rel_p50"] < 1e-6 and n["densify_gap"] == 0.0, n


def test_loss_terms_and_training_forward():
    from blurry_edges_tpu_torch.config import CamConfig, GridConfig, PatchConfig
    from blurry_edges_tpu_torch.models.global_stage import GlobalStage
    from blurry_edges_tpu_torch.ops.dfd import DfDSolver
    from blurry_edges_tpu_torch.train import global_ as tg

    data = make_trainset(5, 2, 41, 121, C147["train"]["data"], CPU)
    e, re = tg.expand_compact_batch(data), rt.expand(data)
    est = torch.randn(2, 121, 12, generator=torch.Generator().manual_seed(0)) * 0.3
    patch = PatchConfig()
    t1, s1, n1 = tg.global_loss_terms(est, e["img_gt"], e["img_gt"], e["bndry_dist"], e["deri"],
                                      e["bndry_depth"], patch, GridConfig(41, 41),
                                      DfDSolver.from_config(CamConfig(), patch))
    t2, s2, n2 = rt.loss_terms(est, re["img"], re["img"], re["bdist"], re["deri"], re["bdepth"],
                               train.ref_cfg(C147), W.DfD(C147["cam"], 21, 4.0))
    torch.testing.assert_close(t1, t2, rtol=1e-5, atol=1e-7)
    assert s1.item() == pytest.approx(s2.item(), rel=1e-5) and n1.item() == n2.item()
    w = make_weights(6, CPU, ("global",))["global"]
    prog = GlobalStage(attn_impl="flash")
    prog.load_state_dict(w)
    seed = fold_in(2 ** 40 + 3, 1)
    torch.testing.assert_close(prog(re["tokens"], train=True, seed=seed),
                               ref.build("global", w, CPU)(re["tokens"], seed=seed),
                               rtol=1e-4, atol=1e-5)


def test_first_steps_agree():
    """The program's first three steps against the reference's at 41x41:
    the numbers that decide ``correct`` far under the cell's limits."""
    class Ctx:
        config = small(C147, img_size=41)
        seed = 2 ** 33 + 1
        device = CPU

    cfg = Ctx.config
    w = make_weights(Ctx.seed, CPU, ("global",))["global"]
    w["generator.weight"].mul_(cfg["train"]["init_scale"]["generator.weight"])
    step, model, opt, mesh, chunks = train.program_step(cfg, w, "flash", 8, CPU)
    data = make_trainset(9, 24, 41, 121, cfg["train"]["data"], CPU)
    gammas = torch.tensor(cfg["train"]["gammas_epoch0"])
    batches = [{k: v[b * 8:(b + 1) * 8] for k, v in data.items()} for b in range(3)]
    losses = [float(step(b, gammas, fold_in(fold_in(Ctx.seed, 0), i))) for i, b in enumerate(batches)]
    after = {k: p.detach() for k, p in model.named_parameters()}
    rl, _, ra = train.reference_steps(Ctx, w, batches, gammas, chunks)
    n = judge.train_numbers(losses, rl, {k: np.ones(1) for k in w}, {k: np.ones(1) for k in w},
                            {k: (after[k] - w[k]).numpy() for k in w},
                            {k: (ra[k] - w[k]).numpy() for k in w})
    assert n["loss_rel"] < 1e-4 and n["change_gap"] < 1e-2, n
    assert all(math.isfinite(x) for x in losses)
