"""A closed loop of single-pair estimator requests whose networks compute
in the configuration's ``precision`` (the program's ``--serve_dtype``),
judged against the plain reference at the same rounding points.

The loop, its timing, the traced sub-window, the sample of answers checked
and what a run records are ``kinds/serve.py``'s: this kind runs a private
copy of that module with two of its functions replaced: the one that
makes the program's estimator, and the check. The estimator is the
program's ``make_depth_estimator``, its three networks built as
``LocalStage(dtype=...)``, ``GlobalStage(dtype=...)`` and ``UNet(dtype=...)``
with the float32 weights, as the program's ``run_eval --serve_dtype``
builds them; the wedge kernels, DfD, fold and densify threshold stay
float32 with TF32 off.

In bfloat16 the served depth cannot be held to the reference's end to
end: the wedge-colors kernel's float32 gaps in the tokens flip some of
the global stage's bfloat16 inputs, and one flip spreads to about an ulp
over its whole output. So the check holds each stage alone on the
program's own input, from the timed requests. A forward hook keeps, for
each pair of the pool, the last request's LocalStage output and
GlobalStage input and output (under the address of the pair's data,
which for the single-pair loop is its row of the pool). Then for each
sampled pair:

- ``local_gap``: the reference's LocalStage on the pair's patches against
  the program's, max |gap| over the reference's max |output|;
- ``global_gap``: the same of the GlobalStage on the program's tokens;
- ``densify_gap`` (``judge.serve_numbers``): the reference's U-Net on the
  program's own folded depth;
- ``held.depth_rel_p50``, ``held.depth_off_share``: those of
  ``judge.serve_numbers`` for the served folded depth against the
  reference's float32 chain (denormalisation, blur levels, render, fold)
  from the program's own GlobalStage output, at float32 grade.

The tokens between the two networks are float32 code that ``be147.serve``
holds at float32 grade. The end-to-end numbers against the same-precision
reference, and under ``float32.`` against the float32 one, are recorded
unjudged: how far this precision's depth lies from the reference's and
from float32's. The control puts the reference with float8 e4m3 operands
in the program's place."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from benchmark import harness, judge
from benchmark.inputs.pairs import make_pairs
from benchmark.inputs.weights import make_weights
from benchmark.kinds import serve
from benchmark.reference import models as ref
from benchmark.reference import models_lowp as lowp
from benchmark.reference import wedge as W
from benchmark.reference.estimator import Estimator
from benchmark.reference.keying import fold_in

# the numbers of judge.serve_numbers read from the chain held at the
# global stage's output
HELD = ("depth_rel_p50", "depth_off_share")


def keep_io(last: dict, nets: dict) -> None:
    """Forward hooks that keep in ``last`` the latest call's LocalStage
    output (its input, the pair's patches, the reference unfolds itself)
    and GlobalStage input and output."""
    def local(mod, args, out):
        last["local"] = out

    def global_(mod, args, out):
        last["global"] = (args[0], out)

    nets["local"].register_forward_hook(local)
    nets["global"].register_forward_hook(global_)


def address(pair: np.ndarray) -> int:
    return pair.__array_interface__["data"][0]


def program_estimator(cfg: dict, weights: dict, batch: int, device, kept: dict):
    """The program's single-pair estimator with its networks computing in
    the configuration's precision; each request files its networks'
    inputs and outputs in ``kept`` under its pair's address."""
    from blurry_edges_tpu_torch.config import CamConfig, GridConfig, PatchConfig
    from blurry_edges_tpu_torch.eval import pipeline
    from blurry_edges_tpu_torch.models.global_stage import GlobalStage
    from blurry_edges_tpu_torch.models.local_stage import LocalStage
    from blurry_edges_tpu_torch.models.unet import UNet

    if batch != 1:
        raise ValueError(f"{__name__} serves single pairs; the traffic asks for {batch}")
    dtype = getattr(torch, cfg["precision"])
    nets = {"local": LocalStage(dtype=dtype), "global": GlobalStage(dtype=dtype)}
    if cfg["densify"] == "pp":
        nets["unet"] = UNet(dtype=dtype)
    for name, net in nets.items():
        net.load_state_dict(weights[name], strict=True)
        net.to(device).eval()
    mods = pipeline.InferenceModules(nets["local"], nets["global"], nets.get("unet"))
    patch = PatchConfig(R=cfg["R"], w=cfg["w"], alpha_lambda=cfg["alpha_lambda"],
                        stride=cfg["stride"], mag=cfg["mag"])
    size = cfg["img_size"]
    fn = pipeline.make_depth_estimator(
        mods, patch, GridConfig(size, size, cfg["R"], cfg["stride"]), CamConfig(**cfg["cam"]),
        densify=None if cfg["densify"] == "threshold" else cfg["densify"],
        rho_prime=cfg["rho_prime"], device=device)
    last = {}
    keep_io(last, nets)

    def estimate(pair):
        out = fn(pair)
        kept[address(pair)] = dict(last)
        return out

    return estimate, nets


def references(ctx, weights: dict, control: bool = False) -> Estimator:
    """The reference estimator on the configuration's networks (float8
    operands for the control), one pair a network call."""
    nets = {k: lowp.build(k, w, ctx.device, control=control) for k, w in weights.items()}
    return Estimator(nets, ctx.config, 1)


def gap(got, want) -> float:
    """max |got - want| over max |want|."""
    g, w = got.double(), want.double()
    return float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))


@torch.no_grad()
def stage_numbers(ctx, reference: Estimator, pair, io: dict, got: dict) -> dict:
    """Each stage of one pair (1, 2, H, W, 3) held alone on the inputs the
    program gave it (``io``: ``keep_io``'s record of its request), against
    ``reference``'s networks; ``got``: the program's served maps."""
    c, nets = ctx.config, reference.nets
    cnn, (tokens, est) = io["local"], io["global"]
    flat = W.unfold(pair.reshape((2,) + pair.shape[2:]), c["R"], c["stride"])
    held = Estimator({"local": lambda _: cnn.float(), "global": lambda _: est.float(),
                      **({"unet": nets["unet"]} if "unet" in nets else {})}, c, 1)
    numbers = serve.judge_pair(held, got, held(pair)[0], ctx.device)
    return {"local_gap": gap(cnn, nets["local"](flat.reshape((-1,) + flat.shape[3:]))),
            "global_gap": gap(est, nets["global"](tokens)),
            **{f"held.{k}": numbers[k] for k in HELD}}


def check_answers(ctx, weights: dict, pool: np.ndarray, answers: list, kept: dict) -> list:
    """The reference over a sample of the answered requests; one row of
    numbers a pair, the float32 reference's under ``float32.``."""
    same = references(ctx, weights)
    f32 = Estimator({k: ref.build(k, w, ctx.device) for k, w in weights.items()}, ctx.config, 1)
    rows = []
    for i in serve.sample(ctx, answers):
        ids, maps = answers[i]
        pair = torch.from_numpy(pool[ids]).to(ctx.device)
        got = {k: v[0] for k, v in maps.items()}
        (want,), (want32,) = same(pair), f32(pair)
        row = serve.judge_pair(same, got, want, ctx.device)
        row.update({f"float32.{k}": v for k, v in
                    serve.judge_pair(f32, got, want32, ctx.device).items()})
        row.update(stage_numbers(ctx, same, pair, kept[address(pool[ids[0]])], got))
        rows.append(row)
    return rows


def run(ctx) -> dict:
    loop = harness.load_module(Path(serve.__file__))
    kept = {}
    loop.program_estimator = lambda cfg, w, batch, dev: program_estimator(cfg, w, batch, dev, kept)
    loop.check_answers = lambda ctx, w, pool, answers: check_answers(ctx, w, pool, answers, kept)
    return loop.run(ctx)


def control(ctx) -> dict:
    """The control at the cell's size: the reference with float8 e4m3
    operands in the program's place, on as many of the seed's pairs as a
    run checks, judged against the reference as the program is. Its
    numbers must fail a limit."""
    cfg, dev = ctx.config, ctx.device
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    weights = make_weights(ctx.seed, dev, ("local", "global", "unet") if cfg["densify"] == "pp"
                           else ("local", "global"))
    pool = make_pairs(fold_in(ctx.seed, 1), ctx.traffic["pool"], cfg["img_size"], cfg, dev)
    exact, fp8 = references(ctx, weights), references(ctx, weights, control=True)
    last = {}
    keep_io(last, fp8.nets)
    ids = np.random.default_rng([ctx.seed % (1 << 63), 7]).permutation(len(pool))
    rows = []
    for r in ids[:ctx.traffic["sample"]]:
        pair = pool[int(r)][None]
        (got,), (want,) = fp8(pair), exact(pair)
        got = {k: v.cpu().numpy() for k, v in got.items()}
        rows.append({**serve.judge_pair(exact, got, want, dev),
                     **stage_numbers(ctx, exact, pair, dict(last), got)})
    return judge.worst(rows)
