"""A closed loop of estimator requests: one client sends a request, waits
for its depth and confidence maps in host memory, and sends the next.

Traffic parameters: ``batch`` pairs a request (1: the single-pair
estimator; more: the batched one), drawn in turn from a ``pool`` of pairs
made at set-up; ``warmup`` requests at set-up; ``sample`` requests whose
answers the reference checks after the window; ``profile_requests`` in the
traced run's profiled sub-window. The configuration decides the estimator:
a ``block`` size means the block-tiled large-image path.

A request is timed from the numpy pairs handed in to the maps back in
host memory. The window sends requests until ``seconds`` have passed and
waits for the last; its length runs to that last answer."""

from __future__ import annotations

import gc
import itertools
import time

import numpy as np
import torch

from benchmark import judge, tracing
from benchmark.counts import models as counts
from benchmark.inputs.pairs import make_pairs
from benchmark.inputs.weights import make_weights
from benchmark.reference import models as ref
from benchmark.reference.estimator import Estimator
from benchmark.reference.keying import fold_in

# the maps a request's answer carries back to host memory
SERVED = ("depth_final", "confidence", "global_depth")


def program_estimator(cfg: dict, weights: dict, batch: int, device):
    """The program's estimator for the configuration, with the weights."""
    from blurry_edges_tpu_torch.config import CamConfig, GridConfig, PatchConfig
    from blurry_edges_tpu_torch.eval import pipeline, pipeline_big
    from blurry_edges_tpu_torch.models.global_stage import GlobalStage
    from blurry_edges_tpu_torch.models.local_stage import LocalStage
    from blurry_edges_tpu_torch.models.unet import UNet

    nets = {"local": LocalStage(), "global": GlobalStage()}
    if cfg["densify"] == "pp":
        nets["unet"] = UNet()
    for name, net in nets.items():
        net.load_state_dict(weights[name], strict=True)
        net.to(device).eval()
    mods = pipeline.InferenceModules(nets["local"], nets["global"], nets.get("unet"))
    patch = PatchConfig(R=cfg["R"], w=cfg["w"], alpha_lambda=cfg["alpha_lambda"],
                        stride=cfg["stride"], mag=cfg["mag"])
    cam = CamConfig(**cfg["cam"])
    size = cfg["img_size"]
    if "block" in cfg:
        fn = pipeline_big.make_big_depth_estimator(
            mods, patch, GridConfig(cfg["block"], cfg["block"], cfg["R"], cfg["stride"]),
            GridConfig(size, size, cfg["R"], cfg["stride"]), cam, cfg["n_margin_patch"],
            rho_prime=cfg["rho_prime"], depth_thres=cfg["depth_thres"], device=device)
    else:
        make = pipeline.make_depth_estimator if batch == 1 else pipeline.make_batched_depth_estimator
        fn = make(mods, patch, GridConfig(size, size, cfg["R"], cfg["stride"]), cam,
                  densify=None if cfg["densify"] == "threshold" else cfg["densify"],
                  rho_prime=cfg["rho_prime"], device=device)
    return fn, nets


def launch_shapes(cfg: dict, batch: int) -> dict:
    """The shape of each wedge kernel launch a request makes (every launch
    of a cell has the same)."""
    R, grids = cfg["R"], group(cfg, batch)
    L = counts.grid_tokens(cfg.get("block", cfg["img_size"]), R, cfg["stride"])
    return {"wedge_colors": {"P": 2 * grids * L, "R": R},
            "wedge_render": {"B": grids, "L": L, "R": R}}


def run(ctx) -> dict:
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batch, cuda = tr["batch"], dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    weights = make_weights(ctx.seed, dev, ("local", "global", "unet") if cfg["densify"] == "pp"
                           else ("local", "global"))
    estimate, nets = program_estimator(cfg, weights, batch, dev)
    pool = make_pairs(fold_in(ctx.seed, 1), tr["pool"], cfg["img_size"], cfg, dev).cpu().numpy()

    def pairs_of(i):
        ids = [(i * batch + j) % len(pool) for j in range(batch)]
        return ids, (pool[ids[0]] if batch == 1 else pool[ids])

    def request(i):
        ids, x = pairs_of(i)
        out = estimate(x)
        return ids, {k: out[k].cpu().numpy().reshape(batch, *pool.shape[2:4]) for k in SERVED}

    for i in range(tr["warmup"]):
        request(i)
    sync()
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    lat, answers, failed = [], [], 0
    t_w = time.perf_counter()
    setup_s = t_w - ctx.t_start
    while time.perf_counter() - t_w < ctx.seconds:
        t0 = time.perf_counter()
        try:
            answers.append(request(len(lat) + failed))
        except Exception as e:  # a request that fails counts, and ends the run
            print(f"request {len(lat) + failed} failed: {e!r}", flush=True)
            failed += 1
            break
        lat.append(time.perf_counter() - t0)
    window_s = time.perf_counter() - t_w
    rec = dict(setup_s=setup_s, window_s=window_s, latencies_s=lat, pairs=batch * len(lat),
               dtype=cfg["precision"])
    if ctx.trace:
        rec["flops_per_pair"] = counts.serve_flops_per_pair(cfg)
        rec["launch_shapes"] = launch_shapes(cfg, batch)
        more = itertools.count(len(lat) + failed)
        rec["trace"] = (tracing.profile(lambda: request(next(more)), tr["profile_requests"])
                        if cuda else None)
        if rec["trace"]:
            rec["breakdown"] = {k: rec["trace"][k] for k in ("device_ops", "idle_gaps")}
    rec["peak_window_bytes"] = torch.cuda.max_memory_allocated() if cuda else 0
    rec["device"] = device_record(ctx, rec.get("trace"), max(setup_peak, rec["peak_window_bytes"]))

    # the check: the program's state freed, then the reference on a sample
    del estimate, nets
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    rows = check_answers(ctx, weights, pool, answers)
    rec["numbers"] = judge.worst(rows)
    limits = ctx.limits
    rec["checks"] = {k: {"value": rec["numbers"].get(k, float("nan")), "limit": limits[k]}
                     for k in limits}
    rec.update(attempted=len(lat) + failed, failed=failed, correct=failed == 0 and bool(rows))
    return rec


def sample(ctx, answers: list) -> list:
    """Answered requests drawn from the seed, each with pairs no earlier
    draw had, up to the traffic's ``sample``."""
    rng = np.random.default_rng([ctx.seed % (1 << 63), 7])
    chosen, seen = [], set()
    for i in rng.permutation(len(answers)):
        ids = tuple(answers[i][0])
        if ids not in seen:
            seen.add(ids)
            chosen.append(i)
        if len(chosen) == ctx.traffic["sample"]:
            break
    return chosen


def group(cfg: dict, batch: int) -> int:
    """Grids the program runs through its networks in one call: the pairs
    of a request, or on the tiled path its chunk of blocks."""
    if "block" in cfg:
        from blurry_edges_tpu_torch.config import BLOCK_CHUNK

        return BLOCK_CHUNK
    return batch


def check_answers(ctx, weights: dict, pool: np.ndarray, answers: list) -> list:
    """The reference over a sample of the answered requests; one row of
    numbers a pair."""
    nets = {k: ref.build(k, w, ctx.device) for k, w in weights.items()}
    reference = Estimator(nets, ctx.config, group(ctx.config, ctx.traffic["batch"]))
    rows = []
    for i in sample(ctx, answers):
        ids, maps = answers[i]
        wants = reference(torch.from_numpy(pool[ids]).to(ctx.device))
        rows += [judge_pair(reference, {k: v[j] for k, v in maps.items()}, want, ctx.device)
                 for j, want in enumerate(wants)]
    return rows


def judge_pair(reference, got: dict, want: dict, device) -> dict:
    """One pair's numbers: ``got`` against ``want``, and against the
    float32 ``reference``'s densify of got's own global depth."""
    dense = reference.densify(*(torch.from_numpy(got[k]).to(device)
                                for k in ("global_depth", "confidence")))
    return judge.serve_numbers(got, {k: v.cpu().numpy() for k, v in want.items()},
                               dense.cpu().numpy())


def control(ctx) -> dict:
    """The control at the cell's size: the reference in TF32 in the
    program's place, on as many of the seed's pairs as a run checks, in the
    program's groups, judged against the float32 reference. Its numbers
    must fail a limit."""
    cfg, dev, batch = ctx.config, ctx.device, ctx.traffic["batch"]
    weights = make_weights(ctx.seed, dev, ("local", "global", "unet") if cfg["densify"] == "pp"
                           else ("local", "global"))
    pool = make_pairs(fold_in(ctx.seed, 1), ctx.traffic["pool"], cfg["img_size"], cfg, dev)
    nets = {k: ref.build(k, w, dev) for k, w in weights.items()}
    exact = Estimator(nets, cfg, group(cfg, batch))
    tf32 = Estimator(nets, cfg, group(cfg, batch), tf32=True)
    ids = np.random.default_rng([ctx.seed % (1 << 63), 7]).permutation(len(pool))
    rows = []
    for r in range(ctx.traffic["sample"]):
        pairs = pool[torch.from_numpy(ids[r * batch:(r + 1) * batch]).to(dev)]
        for got, want in zip(tf32(pairs), exact(pairs)):
            rows.append(judge_pair(exact, {k: v.cpu().numpy() for k, v in got.items()}, want, dev))
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    return judge.worst(rows)


def device_record(ctx, trace, peak_bytes: int) -> dict:
    """The result's ``device``: the card, the run's peak memory, and with a
    trace its busy seconds and the traced window's length."""
    if ctx.device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    d = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
         "count": ctx.cell["chips"], "memory_peak_bytes": int(peak_bytes)}
    if trace:
        d.update(busy_s=trace["busy_s"], window_s=trace["window_s"])
    return d
