"""A loop of the global trainer's optimizer steps on a resident training set.

Set-up builds one training step (the program's ``make_step_fns`` over its
GlobalStage and AdamW) from the benchmark's weights, makes the training
set on the device, and drives the step through its first ``first_steps``
steps; the window goes on with the same object. A step gathers its rows
with the program's ``gather_rows`` in a shuffled order drawn from the
seed, takes epoch 0's loss weights and the trainer's per-step seeds
fold_in(fold_in(seed, 0), step), and ends in ``float(loss)``, the
trainer's own sync. Traffic parameters: ``batch``, ``attn_impl``,
``first_steps``, ``profile_steps``; the configuration's ``train`` block
gives the set's size, the learning rate and the loss weights.

A traced run profiles ``profile_steps`` steps after the window, then one
eager step (``TrainStep.eager``) on its own, whose stage spans a replayed
graph does not open; the memory peak is read before it.

After the window the reference repeats the first steps from the same
weights, rows and seeds, and the losses, the first gradients and the
parameters' change over those steps are compared."""

from __future__ import annotations

import gc
import itertools
import math
import time

import numpy as np
import torch

from benchmark import judge, spans, tracing
from benchmark.counts import models as counts
from benchmark.inputs.trainset import make_trainset
from benchmark.inputs.weights import make_weights
from benchmark.kinds.serve import device_record
from benchmark.reference import models as ref
from benchmark.reference import train as ref_train
from benchmark.reference.keying import fold_in
from benchmark.reference.wedge import DfD


def program_step(cfg: dict, weights: dict, attn_impl: str, batch: int, device):
    """The program's training step and its model and optimizer."""
    from blurry_edges_tpu_torch.config import CamConfig, GridConfig, PatchConfig
    from blurry_edges_tpu_torch.models.global_stage import GlobalStage
    from blurry_edges_tpu_torch.ops.dfd import DfDSolver
    from blurry_edges_tpu_torch.parallel.mesh import make_mesh
    from blurry_edges_tpu_torch.train import global_ as tg
    from blurry_edges_tpu_torch.train.optim import make_optimizer

    g = cfg["global_stage"]
    model = GlobalStage(dropout=g["dropout"], attn_impl=attn_impl)
    model.load_state_dict(weights, strict=True)
    model.to(device)
    opt = make_optimizer(model.parameters(), cfg["train"]["learning_rate"])
    patch = PatchConfig(R=cfg["R"], w=cfg["w"], alpha_lambda=cfg["alpha_lambda"],
                        stride=cfg["stride"], mag=cfg["mag"])
    grid = GridConfig(cfg["img_size"], cfg["img_size"], cfg["R"], cfg["stride"])
    chunks = batch // math.gcd(batch, tg.CHUNK_SAMPLES)
    mesh = make_mesh(device=device)
    step, _ = tg.make_step_fns(model, opt, patch, grid,
                               DfDSolver.from_config(CamConfig(**cfg["cam"]), patch), chunks,
                               mesh=mesh)
    return step, model, opt, mesh, chunks


def ref_cfg(cfg: dict) -> dict:
    return {k: cfg[k] for k in ("R", "w", "lambda_ridge", "stride")}


def run(ctx) -> dict:
    from blurry_edges_tpu_torch.parallel.mesh import gather_rows

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    t = cfg["train"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = dev.type == "cuda"
    batch, n_first = tr["batch"], tr["first_steps"]
    weights = make_weights(ctx.seed, dev, ("global",))["global"]
    for key, scale in t.get("init_scale", {}).items():
        weights[key].mul_(scale)
    step, model, opt, mesh, chunks = program_step(cfg, weights, tr["attn_impl"], batch, dev)
    L = counts.grid_tokens(cfg["img_size"], cfg["R"], cfg["stride"])
    data = make_trainset(fold_in(ctx.seed, 2), t["n_train"], cfg["img_size"], L, t["data"], dev)
    order = np.random.default_rng([ctx.seed % (1 << 63), 3]).permutation(t["n_train"])
    gammas = torch.tensor(t["gammas_epoch0"], dtype=torch.float32, device=dev)
    epoch_seed = fold_in(ctx.seed, 0)

    def rows(b):
        s = (b * batch) % (len(order) - len(order) % batch)
        return order[s:s + batch]

    def one(b):
        return float(step(gather_rows(data, 0, rows(b), mesh), gammas, fold_in(epoch_seed, b)))

    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    losses = [one(0)]
    beta1 = opt.param_groups[0]["betas"][0]
    # the first gradient as the optimizer got it (none: it kept no state)
    grads = {k: opt.state[p].get("exp_avg", torch.zeros_like(p)).detach() / (1.0 - beta1)
             for k, p in model.named_parameters()}
    losses += [one(b) for b in range(1, n_first)]
    change = {k: p.detach() - before[k] for k, p in model.named_parameters()}
    if cuda:
        torch.cuda.synchronize()
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    n, failed = 0, 0
    t_w = time.perf_counter()
    setup_s = t_w - ctx.t_start
    while time.perf_counter() - t_w < ctx.seconds:
        try:
            loss = one(n_first + n)
        except Exception as e:  # a step that fails counts, and ends the run
            print(f"step {n_first + n} failed: {e!r}", flush=True)
            failed += 1
            break
        if not math.isfinite(loss):
            print(f"step {n_first + n}: loss {loss}", flush=True)
            failed += 1
            break
        n += 1
    window_s = time.perf_counter() - t_w
    rec = dict(setup_s=setup_s, window_s=window_s, steps=n, dtype=cfg["precision"])
    if ctx.trace:
        rec["flops_per_step"] = counts.train_flops_per_step(cfg, batch)
        g = cfg["global_stage"]
        shape = {"B": batch // chunks, "H": g["nhead"], "L": L, "D": g["d_model"] // g["nhead"]}
        rec["launch_shapes"] = {k: shape for k in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")}
        more = itertools.count(n_first + n + failed)
        rec["trace"] = (tracing.profile(lambda: one(next(more)), tr["profile_steps"])
                        if cuda else None)
        if rec["trace"]:
            rec["breakdown"] = {k: rec["trace"][k] for k in ("device_ops", "idle_gaps")}
    rec["peak_window_bytes"] = torch.cuda.max_memory_allocated() if cuda else 0
    rec["device"] = device_record(ctx, rec.get("trace"), max(setup_peak, rec["peak_window_bytes"]))
    if rec.get("trace") and hasattr(step, "eager"):
        # a replayed graph opens no stage spans: keep the replays' spans, then
        # profile one eager step on its own for the stages'
        rec["spans"] = spans.summary()
        b = next(more)
        rec["eager_spans"] = spans.profiled(
            lambda: float(step.eager(gather_rows(data, 0, rows(b), mesh), gammas,
                                     fold_in(epoch_seed, b))))

    # the check: the program's state freed, then the reference's first steps
    first_rows = [rows(b) for b in range(n_first)]
    batches = [{k: v[torch.from_numpy(r).to(dev)] for k, v in data.items()} for r in first_rows]
    del step, model, opt, data
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref_losses, ref_grads, ref_after = reference_steps(ctx, weights, batches, gammas, chunks)
    ref_change = {k: ref_after[k] - weights[k] for k in ref_after}
    rec["numbers"] = judge.train_numbers(
        losses, ref_losses, {k: v.cpu().numpy() for k, v in grads.items()},
        {k: v.cpu().numpy() for k, v in ref_grads.items()},
        {k: v.cpu().numpy() for k, v in change.items()},
        {k: v.cpu().numpy() for k, v in ref_change.items()})
    limits = ctx.limits
    rec["checks"] = {k: {"value": rec["numbers"][k], "limit": limits[k]} for k in limits}
    rec.update(attempted=n + failed, failed=failed, correct=failed == 0,
               first_losses=losses, ref_losses=ref_losses)
    return rec


def control(ctx) -> dict:
    """The control at the cell's size: the reference's first steps in TF32
    in the program's place, from the same weights, rows and seeds, judged
    against the float32 reference's. Its numbers must fail a limit."""
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    t = cfg["train"]
    weights = make_weights(ctx.seed, dev, ("global",))["global"]
    for key, scale in t.get("init_scale", {}).items():
        weights[key].mul_(scale)
    L = counts.grid_tokens(cfg["img_size"], cfg["R"], cfg["stride"])
    data = make_trainset(fold_in(ctx.seed, 2), t["n_train"], cfg["img_size"], L, t["data"], dev)
    order = np.random.default_rng([ctx.seed % (1 << 63), 3]).permutation(t["n_train"])
    batch = tr["batch"]
    chunks = batch // math.gcd(batch, t["chunk_samples"])
    batches = [{k: v[torch.from_numpy(order[b * batch:(b + 1) * batch]).to(dev)]
                for k, v in data.items()} for b in range(tr["first_steps"])]
    del data
    gammas = torch.tensor(t["gammas_epoch0"], dtype=torch.float32, device=dev)
    l32, g32, a32 = reference_steps(ctx, weights, batches, gammas, chunks)
    l19, g19, a19 = reference_steps(ctx, weights, batches, gammas, chunks, tf32=True)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

    def np_(d):
        return {k: v.cpu().numpy() for k, v in d.items()}

    return judge.train_numbers(l19, l32, np_(g19), np_(g32),
                               np_({k: a19[k] - weights[k] for k in a19}),
                               np_({k: a32[k] - weights[k] for k in a32}))


def reference_steps(ctx, weights: dict, batches: list, gammas, chunks: int, tf32: bool = False):
    """The reference's first steps (``tf32``: the control, TF32 on)."""
    cfg, dev = ctx.config, ctx.device
    g = cfg["global_stage"]
    model = ref.build("global", weights, dev, dropout=g["dropout"])
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    seeds = [fold_in(fold_in(ctx.seed, 0), b) for b in range(len(batches))]
    dfd = DfD(cfg["cam"], cfg["R"], cfg["mag"])
    return ref_train.steps(model, batches, gammas, seeds, len(batches[0]["imgs_u8"]) // chunks,
                           cfg["train"]["learning_rate"], ref_cfg(cfg), dfd)
