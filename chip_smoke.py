#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

From the repository root, on a machine with one CUDA card and the CUDA
toolkit (``nvcc``). It builds the six kernels from ``csrc/`` (the two wedge
kernels, flash attention's three and the CNN's tail), prints ptxas's
registers, shared memory and spills of the three tensor-core flash kernels
and of both wedge kernels, fails if a flash kernel's SASS holds no
tensor-core instruction, holds each kernel against its plain PyTorch
version at the shapes of the path that runs it and on degenerate or ragged
inputs (the wedge kernels also at the 587x587 path's chunk shapes; the
CNN's tail at its ten junctions, checked on every serving path to launch
ten times a float32 LocalStage forward and never in bfloat16), and
drives the port with seeded random full-width weights: it serves a few
147x147 pairs through the estimators (densify none, w and pp, the last
through the depth-completion U-Net), in float32 and with the networks in
bfloat16; runs the 587x587 block-tiled estimator; runs the evaluation loops
(``run_eval`` in each densify mode, ``run_eval_big``) over a seeded test set
in a temporary directory, one pair's prediction blanked so the exclusion of
empty images runs; and trains the global stage at full width (147x147,
4,096 tokens, 8 layers, batch 8) for three epochs on a seeded synthetic
dataset, then resumes it; and drives the training-data path through the
command line's modes: generates train/val scenes, trains the local stage
for two epochs and resumes it for a third, precalculates the global
stage's tokens with it (the wedge_colors kernel, one launch a device batch
of 8 pairs), trains the global stage on those tokens, generates 147x147
and 587x587 test sets and evaluates them with the weights it trained; then (phase
7c) reads the committed fake MS-COCO / Painting fixture: decodes its JPEGs
with nvJPEG against OpenCV's pixels, generates --coco test sets at
147x147 and 587x587 through the command line, holds the loader's masks,
objects and backgrounds on the card to the CPU's, and evaluates the sets.
It checks the outputs (shapes, finite values,
the launch counts of each path, the bfloat16 estimator against the
float32 chain on its networks' outputs, flash against matmul attention,
the card against the CPU at small sizes; the generated arrays' shapes,
ranges, integer noisy counts, boundary distances, depths and unbiased shot
noise; the card's precal tokens against the CPU chain), times each stage
of the training-data path, the kernels (the wedge
kernels also with the L2 cache flushed before each launch, as the serving
path finds their inputs after the local CNN), the serving paths, the
587x587 estimator and the training step, and prints as its last line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before
that line. Without a CUDA device it exits non-zero at once.

TF32 is off for matmuls and convolutions, so the card computes in float32
as the CPU reference does (bfloat16 where the networks are built so).
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from blurry_edges_tpu_torch.config import (  # noqa: E402
    BLOCK_CHUNK, CamConfig, GridConfig, PatchConfig, get_args)
from blurry_edges_tpu_torch.eval import pipeline as pipe  # noqa: E402
from blurry_edges_tpu_torch.eval import pipeline_big as pipe_big  # noqa: E402
from blurry_edges_tpu_torch.eval.pipeline import (  # noqa: E402
    fold_outputs, make_batched_depth_estimator, make_depth_estimator)
from blurry_edges_tpu_torch.models.layers import set_compute_dtype  # noqa: E402
from blurry_edges_tpu_torch.models.global_stage import GlobalStage  # noqa: E402
from blurry_edges_tpu_torch.models.local_stage import local_epilogue_plain  # noqa: E402
from blurry_edges_tpu_torch.ops import flash_attention as fa  # noqa: E402
from blurry_edges_tpu_torch.ops import local_epilogue as le  # noqa: E402
from blurry_edges_tpu_torch.ops import wedge_cuda  # noqa: E402
from blurry_edges_tpu_torch.ops._build import load_library, sass  # noqa: E402
from blurry_edges_tpu_torch.ops.dfd import DfDSolver  # noqa: E402
from blurry_edges_tpu_torch.ops.params import (  # noqa: E402
    denormalize_global_eval, normalize_token_features, wrap_local_params)
from blurry_edges_tpu_torch.ops.patchify import unfold  # noqa: E402
from blurry_edges_tpu_torch.ops.wedge import params2etas  # noqa: E402
from blurry_edges_tpu_torch.train import global_ as tg  # noqa: E402
from blurry_edges_tpu_torch.train.checkpoint import checkpoint_exists  # noqa: E402
from blurry_edges_tpu_torch.train.optim import make_optimizer, xavier_reinit  # noqa: E402
from blurry_edges_tpu_torch.utils.device import float32_precision  # noqa: E402
from blurry_edges_tpu_torch.utils.seeding import fold_in  # noqa: E402
from blurry_edges_tpu_torch.models.weights import random_modules  # noqa: E402
from tests.local_epilogue_cases import (  # noqa: E402
    JUNCTIONS, biased, conv_biases, junction, kernel_errors)

SEED = 0
N_PAIRS = 4
DENSIFY = (None, "w", "pp")        # the serving paths, single pair and batched
RHO_PRIME = 10.39
# the 587x587 path: 36 blocks of 147x147, margins of 10 patches; the
# kernels' shapes a chunk of c blocks gives (colors P = c x 8,192, render
# B = c) for the default chunk and for all 36 blocks at once
BIG, N_MARGIN, N_BLOCKS = 587, 10, 36
BIG_CHUNKS = tuple(dict.fromkeys((BLOCK_CHUNK, N_BLOCKS)))
OTHER_CHUNK = 1 if BLOCK_CHUNK != 1 else 2   # the second chunk the 587x587 pair is timed at
# H100 SXM peaks (NVIDIA data sheet): HBM rate and float32 outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12      # dense TF32 on the tensor cores
SFU_EXP_PER_CLOCK_SM = 16    # exponentials an SM issues a clock
N_SMS = 132
# the SM clock that TF32_OPS_PER_S assumes: 2,048 dense TF32 operations a
# clock an SM (1.83 GHz)
TF32_CLOCK_HZ = TF32_OPS_PER_S / (N_SMS * 2048)
# float32 operations a pixel that each kernel's function needs (a
# multiply-add counts 2): the counts in the notes at the head of
# csrc/wedge_colors.cu and csrc/wedge_render.cu, which break them down
COLORS_OPS_PER_PIXEL = 150
RENDER_OPS_PER_PIXEL = 420
# float32 operations a (query, key) pair per head dim D, from the notes at
# the head of csrc/flash_attn_fwd.cu, csrc/flash_attn_bwd_dkv.cu and
# csrc/flash_attn_bwd_dq.cu
FLASH_OPS_PER_PAIR_D = {"flash_fwd": 4, "flash_bwd_dkv": 8, "flash_bwd_dq": 6}
# the kernels on the tensor cores in 3xTF32 (three TF32 products for each
# float32 one), with their sources
TENSOR_CORE_KERNELS = {"flash_fwd": "flash_attn_fwd.cu", "flash_bwd_dkv": "flash_attn_bwd_dkv.cu",
                       "flash_bwd_dq": "flash_attn_bwd_dq.cu"}
FLASH_SHAPE = (2, 8, 4096, 16)   # a training chunk: 2 samples, 8 heads, 4,096 tokens
FLASH_SCALE = 0.25               # 1 / sqrt(16)
N_TRAIN, N_VAL, BATCH, LR = 16, 8, 8, 1e-4
# the trainer's step structure (8 layers, chunks of 2 samples): per step
# 3 forward launches a layer and chunk (the forward, the chunk's recompute
# under activation checkpointing, the layer's recompute) and one of each
# backward kernel; per val batch one forward a layer and chunk
N_LAYERS, CHUNKS = 8, BATCH // 2
STEP_LAUNCHES = {"flash_fwd": 3 * CHUNKS * N_LAYERS, "flash_bwd_dkv": CHUNKS * N_LAYERS,
                 "flash_bwd_dq": CHUNKS * N_LAYERS}
VAL_BATCH_LAUNCHES = {"flash_fwd": CHUNKS * N_LAYERS, "flash_bwd_dkv": 0, "flash_bwd_dq": 0}
# the wrappers count the launches a step makes from Python: on one card a
# trainer's step is a CUDA graph (train/global_.py::TrainStep) whose replays
# launch its kernels without them, so only a run's first two steps of one
# batch shape count, the eager warm-up and the capture
PYTHON_STEPS = 2


class CheckFailed(Exception):
    pass


def check(cond, what):
    if not cond:
        raise CheckFailed(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def ptxas_line(log: str, source: str, entry: str = "") -> str:
    """Registers, shared memory a block and spills of the kernel in
    ``source`` (of its first function whose mangled name holds ``entry``,
    where one does), from the build's ptxas output."""
    part = log.split(f"== {source}\n", 1)[-1].split("\n== ", 1)[0]
    part = next((c for c in part.split("Compiling entry function")[1:]
                 if entry and entry in c.split("\n", 1)[0]), part)
    regs = re.search(r"Used (\d+) registers", part)
    smem = re.search(r"(\d+) bytes smem", part)
    spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", part)
    check(regs and spill, f"no ptxas report for {source}")
    return (f"{regs.group(1)} registers, {smem.group(1) if smem else 0} bytes shared memory "
            f"a block, spills {spill.group(1)} B stored / {spill.group(2)} B loaded")


def tensor_core_counts(lib_path, kernels) -> dict:
    """Tensor-core instructions (HMMA, HGMMA) in the SASS of each kernel
    whose mangled name holds ``<name>_kernel``."""
    counts, current = dict.fromkeys(kernels, 0), None
    for ln in sass(lib_path).splitlines():
        if "Function :" in ln:
            current = next((k for k in kernels if f"{k}_kernel" in ln), None)
        elif current and re.search(r"\bH(G)?MMA\b", ln):
            counts[current] += 1
    return counts


def matmul_flops(model, x) -> int:
    """Multiply-add FLOPs (2 a multiply-add) of the convolutions (transposed
    ones too) and linear layers of one forward of ``model`` on ``x``,
    counted by forward hooks."""
    total = 0

    def hook(mod, inputs, out):
        nonlocal total
        if isinstance(mod, torch.nn.Conv2d):
            k = mod.kernel_size[0] * mod.kernel_size[1]
            total += 2 * out.numel() * mod.in_channels * k // mod.groups
        else:
            total += 2 * out.numel() * mod.in_features

    def hook_transposed(mod, inputs, out):   # each input pixel times each kernel tap
        nonlocal total
        total += 2 * inputs[0].numel() * mod.out_channels * mod.kernel_size[0] * mod.kernel_size[1]

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    handles += [m.register_forward_hook(hook_transposed) for m in model.modules()
                if isinstance(m, torch.nn.ConvTranspose2d)]
    try:
        model(x)
    finally:
        for h in handles:
            h.remove()
    return total


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of fn() over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms_cold(fn, iters: int) -> float:
    """Mean device time of fn() with the L2 cache flushed before each call
    (a 256 MB buffer zeroed outside the timed span), as a caller finds its
    inputs after other work has run."""
    scrub = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    fn()
    spans = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(iters)]
    for start, end in spans:
        scrub.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in spans) / iters


def time_wedge(inp, case, patch_cfg, dfd) -> dict:
    """(kernel, case, "warm" or "cold") -> device ms of both wedge kernels on
    a path's inputs (path_inputs): back to back, and with the L2 cache
    flushed before each launch."""
    fns = {"wedge_colors": lambda: wedge_cuda.wedge_colors(inp["params"], inp["flat"], patch_cfg),
           "wedge_render": lambda: wedge_cuda.wedge_render(
               inp["xy"], inp["etas"], inp["img_patches"], patch_cfg, dfd, RHO_PRIME, False)}
    out = {}
    for name, fn in fns.items():
        out[name, case, "warm"] = cuda_ms(fn, 50)
        out[name, case, "cold"] = cuda_ms_cold(fn, 20)
    return out


def epilogue_floats(name: str) -> int:
    """Floats a patch that a LocalStage junction's tail reads and writes at
    least: its layer's output (and the residual) once, the next layer's
    input once. The ten junctions sum to 242,304."""
    C, side, res, pool = JUNCTIONS[name]
    hw = side * side if side else 1
    out = hw if pool is None else ((side + 2 * pool[2] - pool[0]) // pool[1] + 1) ** 2
    return C * (hw * (2 if res else 1) + out)


def check_epilogue(dev) -> dict:
    """The local_epilogue kernel at each of the ten junctions at a 147x147
    pair's 8,192 patches and 4 pairs' (a 587x587 chunk's) 32,768, against
    the plain chain: with fresh BatchNorm statistics (the benchmark's
    weights) equal to it to the bit; with random ones Smish and the pool
    equal to the bit on the kernel's own BatchNorm, which lies within 2
    float32 ulps of the size it works at from the exact one (sums 6). Then
    the device times at 8,192 patches, the kernel's (with the convolutions'
    biases, as the path runs it), the plain chain's with the bias adds it
    replaces and without them, and the kernel's sum over the junctions at
    each block size TILE_FLOATS can take."""
    errs = {"exact": 0.0, "cudnn": 0.0, "cudnn_exact": 0.0}
    ms, plain_ms, plain_nobias_ms, by_tile = {}, {}, {}, {}
    for n in (8192, 32768):
        for trivial in (True, False):
            g = torch.Generator(device=dev).manual_seed(SEED + n + trivial)
            for name in JUNCTIONS:
                a = junction(name, n, g, dev, trivial)
                x, norm, r, rn, pool = (a[k] for k in ("x", "norm", "residual",
                                                       "residual_norm", "pool"))
                b = conv_biases(a, g)
                rb = b.get("residual_bias")
                with torch.no_grad():
                    got = le.local_epilogue_cuda(x, norm, r, rn, pool, **b)
                    plain = local_epilogue_plain(biased(x, b["bias"]), norm, biased(r, rb), rn,
                                                 pool)
                    equal, e = kernel_errors(got, a, b)
                    case = f"{name} at {n} patches, {'fresh' if trivial else 'random'} statistics"
                    check(equal, f"local_epilogue {case}: Smish or the pool off its BatchNorm")
                    check(e["exact"] <= (6.0 if r is not None else 2.0),
                          f"local_epilogue {case}: {e['exact']} ulps from the exact BatchNorm")
                    if trivial:
                        check(torch.equal(got, plain), f"local_epilogue {case}: not the plain "
                              "chain to the bit")
                    for k in errs:
                        errs[k] = max(errs[k], e[k])
                    if n == 8192 and not trivial:
                        ms[name] = cuda_ms(lambda: le.local_epilogue_cuda(x, norm, r, rn, pool,
                                                                          **b), 10)
                        plain_ms[name] = cuda_ms(lambda: local_epilogue_plain(
                            biased(x, b["bias"]), norm, biased(r, rb), rn, pool), 10)
                        plain_nobias_ms[name] = cuda_ms(
                            lambda: local_epilogue_plain(x, norm, r, rn, pool), 10)
                        chosen = le.TILE_FLOATS
                        try:
                            for tile in (4096, 8192, 16384, 32768):
                                le.TILE_FLOATS = tile
                                by_tile[name, tile] = cuda_ms(lambda: le.local_epilogue_cuda(
                                    x, norm, r, rn, pool, **b), 10)
                        finally:
                            le.TILE_FLOATS = chosen
                del a, x, r, got, plain
                torch.cuda.empty_cache()
    tiles = sorted({t for _, t in by_tile})
    return dict(errs=errs, ms=ms, plain_ms=plain_ms, plain_nobias_ms=plain_nobias_ms,
                by_tile={t: sum(by_tile[k, t] for k in JUNCTIONS) for t in tiles})


@contextlib.contextmanager
def counting_epilogue(model, into: dict, path: str, launches_per_forward: int):
    """Counts the local_epilogue kernel's launches and ``model``'s forwards
    over the block into ``into[path]``, and checks
    ``launches_per_forward`` launches a forward (10 for a float32 CNN, one
    a junction; 0 for a bfloat16 one)."""
    forwards = []
    hook = model.register_forward_hook(lambda *args: forwards.append(1))
    le.reset_launch_counts()
    try:
        yield
        torch.cuda.synchronize()
    finally:
        hook.remove()
    into[path] = dict(launches=le.launch_counts()["local_epilogue"], forwards=len(forwards))
    check(forwards and into[path]["launches"] == launches_per_forward * len(forwards),
          f"{path}: local_epilogue launches {into[path]}, want {launches_per_forward} a "
          "LocalStage forward")


def compare_colors(got, want):
    """Kernel 1 against its plain version: rtol 2e-3, atol 2e-4 (float32 sums
    in another order, amplified by the Cayley-Hamilton determinant)."""
    check(torch.isfinite(got).all().item(), "wedge_colors: non-finite output")
    err = (got - want).abs()
    bad = (err > 2e-4 + 2e-3 * want.abs()).sum().item()
    check(bad == 0, f"wedge_colors: {bad} entries outside rtol 2e-3 atol 2e-4")
    return err.max().item()


def compare_render(got, want):
    """Kernel 2 against its plain version, as the JAX package's kernel test
    holds its TPU kernel: the integer mask may flip on under 1e-3 of the
    pixels (knife-edge thresholds under erff vs torch.erf); every float
    output has p99.9 |diff| < 1e-3 * scale and under 2e-3 of its entries
    off by more than 0.01 * scale (mask flips carry into the depth)."""
    check(set(got) == set(want), "wedge_render: output keys differ")
    worst = 0.0
    for k, w in want.items():
        g = got[k]
        check(g.shape == w.shape and g.dtype == w.dtype, f"wedge_render {k}: shape/dtype")
        if k == "depth_mask":
            flips = (g != w).float().mean().item()
            check(flips < 1e-3, f"wedge_render depth_mask: flip fraction {flips}")
            continue
        check(torch.isfinite(g).all().item(), f"wedge_render {k}: non-finite output")
        d = (g - w).abs().flatten()
        scale = max(1.0, w.abs().max().item())
        # quantile of a large tensor: kthvalue, as torch.quantile caps the size
        q = d.kthvalue(max(1, int(np.ceil(0.999 * d.numel())))).values.item()
        far = (d > 0.01 * scale).float().mean().item()
        check(q < 1e-3 * scale, f"wedge_render {k}: p99.9 |diff| {q}")
        check(far < 2e-3, f"wedge_render {k}: {far} of entries off by > 0.01*scale")
        worst = max(worst, d.max().item())
    return worst


def path_inputs(mods, pairs, patch_cfg, grid, dev):
    """What the main path hands each kernel for a stack of pairs, computed as
    the estimator computes it (the colors by the plain version)."""
    B, R, L, Hp = len(pairs), grid.R, grid.num_tokens, grid.H_patches
    imgs = torch.from_numpy(np.stack(pairs)).to(dev)                    # (B, 2, H, W, 3)
    patches = unfold(imgs.reshape((2 * B,) + imgs.shape[2:]), R, grid.stride)
    flat = patches.reshape(2 * B * L, R, R, 3)
    params = wrap_local_params(mods.local_model(flat)).contiguous()
    colors = wedge_cuda.wedge_colors_plain(params, flat, patch_cfg)
    tokens = normalize_token_features(params, colors).reshape(B, 2, L, 19)
    src = tokens.permute(0, 2, 1, 3).reshape(B, L, 38)
    den = denormalize_global_eval(mods.global_model(src)).reshape(B, Hp, Hp, 12)
    return dict(flat=flat, params=params, src=src, xy=den[..., :8].contiguous(),
                etas=params2etas(den[..., 8:]).contiguous(),
                img_patches=patches.reshape((B, 2) + patches.shape[1:]))


def random_render_inputs(B, Hp, Wp, R, seed, dev):
    """Random geometry, etas and pair patches of a (B, Hp, Wp) grid of RxR
    patches."""
    g = torch.Generator().manual_seed(seed)
    xy = torch.cat([torch.rand((B, Hp, Wp, 4), generator=g) * 1.6 - 0.8,
                    torch.rand((B, Hp, Wp, 4), generator=g) * 2 * np.pi], -1)
    etas = params2etas(torch.randn((B, Hp, Wp, 4), generator=g))
    imgs = torch.rand((B, 2, Hp, Wp, R, R, 3), generator=g)
    return xy.to(dev), etas.to(dev), imgs.to(dev)


def make_pairs(rng, n, H):
    """Alpha-normalized test pairs: a smooth color ramp per image plus noise."""
    yy, xx = np.mgrid[0:H, 0:H].astype(np.float32) / H
    pairs = []
    for _ in range(n):
        a, b = rng.uniform(0.2, 0.8, 2)
        base = np.stack([a * xx + (1 - a) * yy, b * yy + 0.2, 0.5 * (xx + yy)], -1)
        pair = np.stack([base, base[::-1]]) + rng.normal(0, 0.05, (2, H, H, 3))
        pairs.append(np.clip(pair, 0, 1).astype(np.float32))
    return pairs


def big_kernel_inputs(four, c, dev):
    """Both wedge kernels' inputs at a chunk of c blocks of the 587x587
    path (colors P = c x 8,192, render B = c): the x4 serving path's
    inputs, tiled, the colors' params moved by a seeded N(0, 0.01) so that
    no two tiles are the same."""
    reps = -(-c // N_PAIRS)
    P = c * four["params"].shape[0] // N_PAIRS
    g = torch.Generator(device=dev).manual_seed(SEED + 20 + c)
    params = four["params"].repeat(reps, 1)[:P]
    params = (params + 0.01 * torch.randn(params.shape, generator=g, device=dev)).contiguous()
    flat = four["flat"].repeat(reps, 1, 1, 1)[:P].contiguous()
    xy = four["xy"].repeat(reps, 1, 1, 1)[:c].contiguous()
    etas = four["etas"].repeat(reps, 1, 1, 1)[:c].contiguous()
    imgs = four["img_patches"].repeat(reps, 1, 1, 1, 1, 1, 1)[:c].contiguous()
    return params, flat, xy, etas, imgs


def compare_big(params, flat, xy, etas, imgs, patch_cfg, dfd):
    """Both kernels launched once at a big chunk's shape, held against their
    plain versions on the same inputs, computed 4 blocks at a time (each
    patch's result depends on that patch alone) and compared a slice at a
    time with compare_colors' and compare_render's tolerances."""
    colors = wedge_cuda.wedge_colors(params, flat, patch_cfg)
    step = 4 * params.shape[0] // xy.shape[0]
    e_colors = max(compare_colors(colors[i:i + step], wedge_cuda.wedge_colors_plain(
        params[i:i + step], flat[i:i + step], patch_cfg)) for i in range(0, len(params), step))
    del colors
    rend = wedge_cuda.wedge_render(xy, etas, imgs, patch_cfg, dfd, RHO_PRIME, False)
    e_render = 0.0
    for b in range(0, xy.shape[0], 4):
        got = {k: v[b:b + 4] for k, v in rend.items()}
        want = wedge_cuda.wedge_render_plain(xy[b:b + 4], etas[b:b + 4], imgs[b:b + 4],
                                             patch_cfg, dfd, RHO_PRIME, False)
        e_render = max(e_render, compare_render(got, want))
    return e_colors, e_render


@contextlib.contextmanager
def blanking(module, name: str, call: int):
    """``module.<name>`` (an estimator factory) wrapped so that the estimator
    it builds returns an all-zero depth_final at its ``call``-th call (0 is
    the eval loop's warm-up), as tests/test_eval_empty_guard.py blanks one."""
    make = getattr(module, name)

    def wrapped(*a, **k):
        est, n = make(*a, **k), [0]

        def estimate(img):
            out = est(img)
            if n[0] == call:
                out["depth_final"] = torch.zeros_like(out["depth_final"])
            n[0] += 1
            return out
        return estimate

    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, make)


def write_test_set(path: Path, pairs, seed: int):
    """A test set in the generator's layout from alpha-normalized pairs:
    integer photon counts at alpha 180-200, depth maps of two planes."""
    rng = np.random.default_rng(seed)
    n, H = len(pairs), pairs[0].shape[1]
    alphas = rng.uniform(180, 200, n).astype(np.float32)
    yy = np.mgrid[0:H, 0:H][0].astype(np.float32) / H
    path.mkdir(parents=True)
    np.save(path / "images_ny.npy", np.stack([np.round(p * a) for p, a in zip(pairs, alphas)])
            .astype(np.uint8))
    np.save(path / "depth_maps.npy", np.stack([np.where(yy < rng.uniform(0.3, 0.7), 0.8, 1.1)
                                               for _ in pairs]).astype(np.float32))
    np.save(path / "alphas.npy", alphas)


def run_loop(fn, *args, **kw):
    """fn(*args, **kw) with its standard output captured: (result, log)."""
    log = io.StringIO()
    with redirect_stdout(log):
        res = fn(*args, **kw)
    return res, log.getvalue()


def check_eval_log(what, res, log, n, blank):
    """An eval loop's dict and prints: every pair but ``blank`` scored (or
    excluded for an empty prediction of its own), ``blank`` excluded and
    reported, finite averages over the scored ones."""
    check(set(res) == {"delta1", "delta2", "delta3", "rmse", "absrel", "avg_time",
                       "pairs_per_sec"}, f"{what}: keys {sorted(res)}")
    check(f"Image pair #{blank}: no predicted pixels above threshold; excluded" in log,
          f"{what}: the blanked pair was not excluded")
    scored = [j for j in range(n) if re.search(rf"Image pair #{j}: delta1 =", log)]
    check(blank not in scored and len(scored) >= 1, f"{what}: scored pairs {scored}")
    check(f"{n - len(scored)}/{n} images had empty predictions" in log
          and f"(over {len(scored)}/{n} scored images)" in log, f"{what}: exclusion report")
    check(all(math.isfinite(res[k]) for k in res) and res["pairs_per_sec"] > 0,
          f"{what}: averages {res}")
    return scored


# --------------------------------------------------------------- flash


def flash_inputs(shape, seed, dev):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(dev) for _ in range(4)]


def compare_flash(shape, seed, dev):
    """The three flash kernels against their plain versions: max |diff|
    under 1e-5 * scale for o and lse, 1e-4 * scale for dq, dk, dv (scale:
    the plain result's largest |value|, at least 1). Both sides are float32
    and sum in another order (the kernels blockwise with an online softmax,
    the plain version by matmul). Returns the max |diff| of each kernel."""
    q, k, v, dout = flash_inputs(shape, seed, dev)
    o, lse = fa.flash_attention_fwd(q, k, v, FLASH_SCALE)
    o_p, lse_p = fa.flash_attention_plain(q, k, v, FLASH_SCALE)
    di = (o * dout).sum(-1)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, dout, lse, di, FLASH_SCALE)
    dq = fa.flash_attention_bwd_dq(q, k, v, dout, lse, di, FLASH_SCALE)
    dq_p, dk_p, dv_p = fa.flash_attention_bwd_plain(q, k, v, o_p, lse_p, dout, FLASH_SCALE)
    torch.cuda.synchronize()
    errs = {}
    for kernel, pairs, tol in (("flash_fwd", (("o", o, o_p), ("lse", lse, lse_p)), 1e-5),
                               ("flash_bwd_dkv", (("dk", dk, dk_p), ("dv", dv, dv_p)), 1e-4),
                               ("flash_bwd_dq", (("dq", dq, dq_p),), 1e-4)):
        errs[kernel] = 0.0
        for name, got, want in pairs:
            check(torch.isfinite(got).all().item(), f"{kernel} {name}: non-finite output")
            err = (got - want).abs().max().item()
            scale = max(1.0, want.abs().max().item())
            check(err < tol * scale, f"{kernel} {name} {shape}: max|diff| {err} >= {tol} * {scale}")
            errs[kernel] = max(errs[kernel], err)
    return errs


def flash_bounds(shape):
    """Two bounds of each flash kernel at ``shape``, each (ms, bound_by):
    "fp32", the larger of the bytes (each input read once, each output
    written once) over the HBM rate and the float32 operations over the
    float32 peak; "tensor_core", the largest of the bytes, three times the
    operations (3xTF32) over the dense TF32 peak and the L^2 exponentials a
    head over the SFUs, taken at the clock the TF32 peak assumes so that both
    terms count one clock."""
    B, H, L, D = shape
    row, vec = B * H * L * D * 4, B * H * L * 4
    bytes_ = {"flash_fwd": 4 * row + vec,              # q, k, v -> o, lse
              "flash_bwd_dkv": 6 * row + 2 * vec,      # q, k, v, dO, lse, di -> dk, dv
              "flash_bwd_dq": 5 * row + 2 * vec}       # q, k, v, dO, lse, di -> dq
    t_exp = B * H * L * L / (N_SMS * SFU_EXP_PER_CLOCK_SM * TF32_CLOCK_HZ) * 1e3
    out = {}
    for name, per in FLASH_OPS_PER_PAIR_D.items():
        t_bytes = bytes_[name] / HBM_BYTES_PER_S * 1e3
        ops = per * B * H * L * L * D
        t_ops, t_tc = ops / F32_OPS_PER_S * 1e3, 3 * ops / TF32_OPS_PER_S * 1e3
        out[name] = {
            "fp32": (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"),
            "tensor_core": (max(t_bytes, t_tc, t_exp),
                            "bytes" if t_bytes >= max(t_tc, t_exp) else "operations")}
    return out


def time_flash(dev):
    """Device ms of each flash kernel, of its plain version and of
    scaled_dot_product_attention (the library call: forward for flash_fwd,
    its backward, which gives dq, dk and dv at once, for both backward
    kernels) at FLASH_SHAPE."""
    q, k, v, dout = flash_inputs(FLASH_SHAPE, SEED + 7, dev)
    o, lse = fa.flash_attention_fwd(q, k, v, FLASH_SCALE)
    di = (o * dout).sum(-1)
    ms = {"flash_fwd": cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, FLASH_SCALE), 20),
          "flash_bwd_dkv": cuda_ms(lambda: fa.flash_attention_bwd_dkv(
              q, k, v, dout, lse, di, FLASH_SCALE), 20),
          "flash_bwd_dq": cuda_ms(lambda: fa.flash_attention_bwd_dq(
              q, k, v, dout, lse, di, FLASH_SCALE), 20)}
    plain_fwd = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, FLASH_SCALE), 5)
    plain_bwd = cuda_ms(lambda: fa.flash_attention_bwd_plain(
        q, k, v, o, lse, dout, FLASH_SCALE), 5)
    plain = {"flash_fwd": plain_fwd, "flash_bwd_dkv": plain_bwd, "flash_bwd_dq": plain_bwd}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    with torch.no_grad():
        lib_fwd = cuda_ms(lambda: sdpa(q, k, v, scale=FLASH_SCALE), 20)
    lib_both = cuda_ms(lambda: torch.autograd.grad(sdpa(*leaves, scale=FLASH_SCALE),
                                                   leaves, dout), 20)
    library = {"flash_fwd": lib_fwd, "flash_bwd_dkv": lib_both - lib_fwd,
               "flash_bwd_dq": lib_both - lib_fwd}
    return ms, plain, library


# --------------------------------------------------------------- training


def write_dataset(path: Path, n_train: int, n_val: int, grid: GridConfig, seed: int):
    """A seeded dataset in load_global_compact's layout: clean images are
    integer photon counts times alpha / 255 (so the uint8 round trip is
    exact), noisy ones Poisson-like integers, boundary depths on a ring of
    rows, tokens N(0, 0.3)."""
    rng = np.random.default_rng(seed)
    H, L = grid.H, grid.num_tokens
    for part, n in (("train", n_train), ("val", n_val)):
        alpha = rng.uniform(180, 200, (n,)).astype(np.float32)
        a = alpha[:, None, None, None, None]
        counts = rng.integers(0, 256, (n, 2, H, H, 3)).astype(np.float32)
        bd = np.zeros((n, H, H), np.float32)
        bd[:, ::6, :] = rng.uniform(0.75, 1.18, (n, (H + 5) // 6, H))
        arrays = {"alphas": alpha,
                  "params_src": rng.normal(scale=0.3, size=(n, 2, L, 19)).astype(np.float32),
                  "images_gt": (counts / 255.0 * a).astype(np.float32),
                  "boundary_distances": rng.integers(0, 40, (n, H, H)).astype(np.float32),
                  "boundary_depths": bd,
                  "images_ny": np.clip(np.round(counts / 255.0 * a + rng.normal(
                      0, 2, counts.shape)), 0, 255).astype(np.float32)}
        for name, arr in arrays.items():
            np.save(path / f"{name}_{part}.npy", arr)


def trainer_args(root: Path, **over) -> argparse.Namespace:
    args = get_args("global_train", argv=[])
    args.data_path, args.log_path, args.model_path = (
        str(root / "data"), str(root / "logs"), str(root / "weights"))
    args.batch_size, args.epoch_num, args.dynamic_epoch = BATCH, 3, [2, 2, 4]
    args.attn_impl = "flash"
    for k, v in over.items():
        setattr(args, k, v)
    return args


def run_trainer(root: Path):
    """The global trainer's main path: 3 epochs of 2 steps (the plateau gate
    opens at the last), then a second call with one epoch more that resumes
    from the step snapshot. Returns the launches of each call, the losses,
    and the seconds of each call."""
    out = {}
    for name, epochs in (("train", 3), ("resume", 4)):
        args = trainer_args(root, epoch_num=epochs)
        fa.reset_launch_counts()
        wedge_cuda.reset_launch_counts()
        log = io.StringIO()
        t0 = time.perf_counter()
        with redirect_stdout(log):
            tg.run_global_training(args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        out[name] = dict(flash=fa.launch_counts(), wedge=wedge_cuda.launch_counts(),
                         seconds=seconds, log=log.getvalue())
    steps = [ln.split() for ln in (root / "logs" / "global_steps.log").read_text().splitlines()
             if ln.strip()]
    losses = [float(s[2]) for s in steps]
    curve = np.load(root / "logs" / "loss_curve_exp_global_stage.npy")
    return out, losses, curve


def fresh_model(attn_impl: str, n_layers: int, dev, seed: int = 1898):
    """A GlobalStage with dropout 0 from the trainer's seeded init, with the
    generator's kernel scaled by 1/4 so the etas start in the loss's
    well-conditioned range (from the Xavier init many start at their floor
    of 1e-4, where erf slopes ~1/eta make the gradient ill-conditioned)."""
    model = GlobalStage(num_encoder_layers=n_layers, dropout=0.0, attn_impl=attn_impl)
    xavier_reinit(model, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        model.generator.weight.mul_(0.25)
    return model.to(dev)


def one_step(model, batch, grid, patch_cfg, dfd, grad_accum):
    """Loss, clipped gradients and the update over lr of one train step."""
    before = [p.detach().clone() for p in model.parameters()]
    opt = make_optimizer(model.parameters(), LR)
    step, _ = tg.make_step_fns(model, opt, patch_cfg, grid, dfd, grad_accum)
    loss = float(step(batch, tg.gammas_to_array(GAMMAS, batch["input_param"].device), 0))
    grads = torch.cat([p.grad.detach().flatten().cpu() for p in model.parameters()])
    upd = torch.cat([((p.detach() - b) / LR).flatten().cpu()
                     for p, b in zip(model.parameters(), before)])
    return loss, grads.double(), upd.double()


def compare_steps(a, b, what):
    """Two one-step results of the same function from fresh_model's init:
    the loss within rtol 1e-5, the clipped gradients within a relative L2
    error of 1e-3 (float32 on both sides, summed in another order; from
    that init a float32-level change of the global stage's output moves
    the gradient by ~4e-5, tests/test_torch_train_step.py), and Adam's
    first-step updates (about the gradient's sign) within 2e-3 of lr
    wherever the gradient is at least 1e-2 of the gradients' RMS, and
    everywhere within 2 lr."""
    (la, ga, ua), (lb, gb, ub) = a, b
    rel = abs(la - lb) / abs(lb)
    check(rel < 1e-5, f"{what}: loss {la} vs {lb}")
    g_rel = ((ga - gb).norm() / gb.norm()).item()
    check(g_rel < 1e-3, f"{what}: gradient relative L2 {g_rel}")
    d = (ua - ub).abs()
    clear = gb.abs() >= 1e-2 * gb.square().mean().sqrt()
    check(d.max().item() <= 2.0, f"{what}: update differs by {d.max().item()} lr")
    worst = d[clear].max().item()
    check(worst < 2e-3, f"{what}: update differs by {worst} lr on a clear gradient")
    return dict(loss_rel=rel, grad_rel_l2=g_rel, update_max_diff=worst,
                clear_share=clear.double().mean().item())


GAMMAS = {"color": 0.1, "color_cons": 0.05, "bndry_cons": 0.02, "smthns": 0.002,
          "smthns_cons": 0.002, "bndry_loc": 0.0001, "depth": 0.5}


def profile_step(batch, gammas, grid, patch_cfg, dfd, dev) -> str:
    """Device time of one full-width flash training step by kernel, from
    torch.profiler: the share of the flash kernels, of matrix products, of
    everything else, and the device's idle share of the step's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model = GlobalStage(attn_impl="flash")
    xavier_reinit(model, torch.Generator().manual_seed(1898))
    model.to(dev)
    step, _ = tg.make_step_fns(model, make_optimizer(model.parameters(), LR), patch_cfg,
                               grid, dfd, CHUNKS)
    step(batch, gammas, 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch, gammas, 1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for ev in prof.key_averages():    # the kernels themselves, not the ops that launched them
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + ev.self_device_time_total / 1e3
    total = sum(by_name.values())
    if total == 0:
        return "profile train step: device time not measured (the profiler saw no kernel)"
    flash = sum(v for k, v in by_name.items() if "flash_" in k)
    gemm = sum(v for k, v in by_name.items()
               if any(w in k.lower() for w in ("gemm", "sm90_", "cutlass", "ampere_")))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return (f"profile train step (flash, full width, batch 8): wall {wall_ms:.1f} ms, device "
            f"{total:.1f} ms (idle {1 - total / wall_ms:.1%}); flash kernels {flash:.1f} ms "
            f"({flash / total:.1%}), matrix products {gemm:.1f} ms ({gemm / total:.1%}), other "
            f"{total - flash - gemm:.1f} ms; {len(by_name)} kernels; top: "
            + "; ".join(f"{k[:60]} {v:.1f} ms" for k, v in top))


# --------------------------------------------------------------- training data

# the training-data path: train/val scenes (2 patches a scene, so the local
# trainer has 2 train batches of 64 and 1 val batch), precal in device
# batches of 8 pairs (12 wedge_colors launches), test sets of 3 pairs at
# 147x147 and 2 at 587x587
N_GEN_TRAIN, N_GEN_VAL, PRECAL_BATCH = 64, 32, 8
N_GEN_TEST, N_GEN_TEST_BIG = 3, 2
Z_RANGE, SIGMA_READ = (0.75, 1.18), 2.0


def noise_bias(gt, ny, alpha):
    """Mean of (noisy - clean) photon counts over the pixels clear of both
    clips (10 < clean < alpha - 30), in standard errors of that mean (each
    pixel's variance clean + sigma^2 + 1/12: shot noise, read noise,
    rounding)."""
    a = alpha.reshape((-1,) + (1,) * (gt.ndim - 1))
    keep = (gt > 10) & (gt < a - 30)
    d = (ny - gt)[keep].astype(np.float64)
    se = math.sqrt((gt[keep].astype(np.float64).mean() + SIGMA_READ ** 2 + 1 / 12) / d.size)
    return d.mean() / se


def check_noisy(what, gt, ny, alpha, shape, clean_le_alpha: bool = True):
    """Shapes, float32, integer noisy counts in [0, round(alpha)] (clipped
    to alpha, then rounded), clean counts in [0, alpha] (or, without
    ``clean_le_alpha``, at least 0), shot noise without bias (its mean
    within 4 standard errors of 0)."""
    a = alpha.reshape((-1,) + (1,) * (gt.ndim - 1))
    check(gt.shape == ny.shape == shape and gt.dtype == ny.dtype == np.float32,
          f"{what}: shapes {gt.shape} {ny.shape}, want {shape} float32")
    check(((alpha >= 180) & (alpha < 200)).all(), f"{what}: alphas outside [180, 200)")
    check((ny == np.round(ny)).all() and ny.min() >= 0 and (ny <= np.round(a)).all(),
          f"{what}: noisy counts not integers in [0, round(alpha)]")
    check(gt.min() >= 0 and (not clean_le_alpha or (gt <= a + 1e-3).all()),
          f"{what}: clean counts outside [0, alpha]")
    z = noise_bias(gt, ny, alpha)
    check(abs(z) < 4, f"{what}: shot noise biased by {z:.2f} standard errors")
    return z


def check_generated_trainval(data: Path, H: int) -> dict:
    """The train/val arrays the generator wrote: shapes, ranges, noise, a
    boundary distance of 0 on every boundary pixel (and only there), depths
    inside Z_range, the patch set's shapes and distances."""
    zs = {}
    for part, n in (("train", N_GEN_TRAIN), ("val", N_GEN_VAL)):
        ld = lambda name: np.load(data / f"{name}_{part}.npy")           # noqa: E731
        zs[part] = check_noisy(f"gen_trainval {part}", ld("images_gt"), ld("images_ny"),
                               ld("alphas"), (n, 2, H, H, 3))
        bloc, dist = ld("boundary_locations"), ld("boundary_distances")
        check((bloc > 0).any(axis=(1, 2)).all(), f"gen_trainval {part}: a scene without boundary")
        check((dist[bloc > 0] == 0).all() and (dist[bloc == 0] > 0).all(),
              f"gen_trainval {part}: boundary distance not 0 exactly on the boundary")
        depth, bdep = ld("image_depths"), ld("boundary_depths")
        check(depth.min() >= Z_RANGE[0] and depth.max() <= Z_RANGE[1]
              and bdep.min() >= 0 and bdep.max() <= Z_RANGE[1],
              f"gen_trainval {part}: depths outside Z_range")
        aif, deri = ld("images_aif"), ld("derivative_maps")
        check(aif.shape == (n, H, H, 3) and aif.min() >= 0 and aif.max() <= 1
              and deri.shape == (n, 2, H, H, 3) and np.isfinite(deri).all(),
              f"gen_trainval {part}: aif / derivative maps")
        pl = lambda name: np.load(data / "patches" / f"{name}_{part}.npy")   # noqa: E731
        check(pl("patches_ny").shape == (2 * n, 21, 21, 3)
              and (pl("boundary_distances")[pl("boundary_locations") > 0] == 0).all(),
              f"gen_trainval {part}: patch set")
    return zs


def check_generated_test(path: Path, n: int, H: int, clean_le_alpha: bool = True) -> float:
    ld = lambda name: np.load(path / f"{name}.npy")                   # noqa: E731
    z = check_noisy(f"gen_test {path.name}", ld("images_gt"), ld("images_ny"), ld("alphas"),
                    (n, 2, H, H, 3), clean_le_alpha)
    depth = ld("depth_maps")
    check(depth.shape == (n, H, H) and depth.min() >= Z_RANGE[0]
          and depth.max() <= Z_RANGE[1] + 1e-6, f"gen_test {path.name}: depths")
    return z


class Stages:
    """Seconds (host clock around work that ends in a synchronize) and peak
    device memory of each stage of a path."""

    def __init__(self, dev):
        self.dev, self.rows = dev, {}

    @contextlib.contextmanager
    def __call__(self, name):
        torch.cuda.synchronize(self.dev)
        torch.cuda.reset_peak_memory_stats(self.dev)
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize(self.dev)
        self.rows[name] = (time.perf_counter() - t0,
                           torch.cuda.max_memory_allocated(self.dev) / 2**30)

    def line(self):
        return "; ".join(f"{k} {s:.2f} s ({g:.2f} GiB)" for k, (s, g) in self.rows.items())


def run_datagen_path(root: Path, dev, grid: GridConfig, patch_cfg: PatchConfig):
    """The training-data path through the command line's modes on the card:
    gen_trainval, local_train for 2 epochs and a resumed third, global_precal
    with that local stage, global_train on those tokens, gen_test (147x147
    and --big), then run_eval (densify none and w) and run_eval_big with the
    weights the path trained. Each kernel's launches are counted from 0
    just before each stage. Returns (launches by stage, stage clock,
    checks' numbers)."""
    from blurry_edges_tpu_torch import cli
    from blurry_edges_tpu_torch.train import local as tl
    from blurry_edges_tpu_torch.train.global_precal import load_local_stage, make_precal_fn
    from blurry_edges_tpu_torch.models.weights import load_inference_modules

    cuda, H = ["--cuda", str(dev)], grid.H
    data, w = root / "data", root / "w"
    clock, launches, notes = Stages(dev), {}, {}

    def counted(name):
        fa.reset_launch_counts()
        wedge_cuda.reset_launch_counts()
        return clock(name)

    def read(name):
        launches[name] = {**wedge_cuda.launch_counts(), **fa.launch_counts()}
        return launches[name]

    with counted("gen_trainval"), redirect_stdout(io.StringIO()):
        phases = cli.gen_trainval_main(cuda + ["--data_path", str(data), "--num_sample_train",
                                               str(N_GEN_TRAIN), "--num_sample_val",
                                               str(N_GEN_VAL)])
    read("gen_trainval")
    notes["gen_phases"] = phases
    notes["noise_z"] = check_generated_trainval(data, H)

    largs = lambda epochs: get_args("local_train", argv=[                  # noqa: E731
        "--data_path", str(data / "patches"), "--log_path", str(root / "logs_local"),
        "--model_path", str(w), "--epoch_num", str(epochs)])
    with counted("local_train"):
        first, _ = run_loop(tl.run_local_training, largs(2), snapshot_every=1, device=dev)
    read("local_train")
    with counted("local_train_resume"):
        again, log = run_loop(tl.run_local_training, largs(3), snapshot_every=1, device=dev)
    read("local_train_resume")
    check(first["steps"] == 2 * 2 and again["start_epoch"] == 2 and again["steps"] == 2
          and "RESUMED at epoch 2" in log and np.isfinite(again["curve"]).all()
          and checkpoint_exists(str(w / "best_run_exp_local_stage")),
          f"local_train: {first}, {again}")
    notes["local_curve"] = again["curve"].tolist()
    notes["determinism"] = determinism_reading(data, root, dev)
    print(f"step 0, determinism (local_train 2 epochs, twice each way): {notes['determinism']}",
          flush=True)

    with counted("global_precal"):
        precal, _ = run_loop(cli.global_precal_main, cuda + [
            "--data_path", str(data), "--model_path", str(w)])
    read("global_precal")
    n_launch = -(-N_GEN_TRAIN // PRECAL_BATCH) + -(-N_GEN_VAL // PRECAL_BATCH)
    check(launches["global_precal"]["wedge_colors"] == n_launch
          and launches["global_precal"]["wedge_render"] == 0,
          f"global_precal launches {launches['global_precal']}, want {n_launch} wedge_colors")
    tokens = np.load(data / "params_src_train.npy")
    check(tokens.shape == (N_GEN_TRAIN, 2, grid.num_tokens, 19) and tokens.dtype == np.float32
          and np.isfinite(tokens).all(), f"params_src_train {tokens.shape} {tokens.dtype}")
    notes["precal_seconds"] = precal

    # the card's tokens of the first 4 pairs against the CPU chain (plain
    # colors), as tests/test_torch_cuda.py::test_precal_tokens_card_vs_cpu
    # holds them: at most 1% of the entries outside rtol 2e-3 / atol 2e-4
    pairs = torch.from_numpy(np.load(data / "images_ny_train.npy")[:4]
                             / np.load(data / "alphas_train.npy")[:4, None, None, None, None])
    with redirect_stdout(io.StringIO()):
        want = make_precal_fn(load_local_stage(str(w), "cpu"), patch_cfg, grid)(pairs)
    d = (torch.from_numpy(tokens[:4]) - want).abs()
    far = (d > 2e-4 + 2e-3 * want.abs()).float().mean().item()
    check(far <= 1e-2, f"precal card vs CPU: {far} of the token entries outside rtol 2e-3 atol 2e-4")
    notes["precal_vs_cpu"] = dict(far_share=far, max_abs=d.max().item(),
                                  p99_abs=d.flatten().kthvalue(int(0.99 * d.numel())).values.item())

    # the kernel alone against its plain version on one precal device
    # batch's own inputs (P = 8 x 2 x 4,096 patches), with no allowance
    imgs = torch.from_numpy(
        np.load(data / "images_ny_train.npy", mmap_mode="r")[:PRECAL_BATCH]
        / np.load(data / "alphas_train.npy")[:PRECAL_BATCH, None, None, None, None]).to(dev)
    with redirect_stdout(io.StringIO()):
        model = load_local_stage(str(w), dev)
    with torch.inference_mode(), float32_precision():
        flat = unfold(imgs.reshape((-1,) + imgs.shape[2:]), grid.R, grid.stride)
        flat = flat.reshape(-1, grid.R, grid.R, 3).contiguous()
        params = wrap_local_params(model(flat)).contiguous()
        got = wedge_cuda.wedge_colors(params, flat, patch_cfg)
        want = wedge_cuda.wedge_colors_plain(params, flat, patch_cfg)
    notes["precal_colors_vs_plain"] = dict(patches=len(params),
                                           max_abs=compare_colors(got, want))
    del model, imgs, flat, params, got, want
    notes["cnn_float64"] = cnn_float64_reading(w, data, grid, dev)
    print(f"step 0, float32 local CNN vs float64: {notes['cnn_float64']}", flush=True)

    gargs = get_args("global_train", argv=[
        "--data_path", str(data), "--model_path", str(w), "--log_path", str(root / "logs_global"),
        "--epoch_num", "1", "--attn_impl", "flash"])
    with counted("global_train"):
        _, glog = run_loop(tg.run_global_training, gargs, device=dev)
    read("global_train")
    steps, val_batches = N_GEN_TRAIN // BATCH, N_GEN_VAL // BATCH
    want_flash = {k: min(steps, PYTHON_STEPS) * STEP_LAUNCHES[k]
                  + val_batches * VAL_BATCH_LAUNCHES[k] for k in STEP_LAUNCHES}
    got_flash = {k: launches["global_train"][k] for k in STEP_LAUNCHES}
    curve = np.load(root / "logs_global" / "loss_curve_exp_global_stage.npy")
    check(got_flash == want_flash and np.isfinite(curve).all()
          and checkpoint_exists(str(w / "best_run_exp_global_stage")),
          f"global_train on the generated tokens: flash {got_flash}, want {want_flash}, "
          f"curve {curve}")
    notes["global_val"] = curve.tolist()

    with counted("gen_test"):
        cli.gen_test_main(cuda + ["--data_path", str(root / "data_test"),
                                  "--num_sample_test", str(N_GEN_TEST)])
    read("gen_test")
    with counted("gen_test_big"):
        cli.gen_test_main(["--big"] + cuda + ["--data_path", str(root / "data_test"),
                                              "--num_sample_test", str(N_GEN_TEST_BIG)])
    read("gen_test_big")
    notes["test_noise_z"] = [check_generated_test(root / "data_test", N_GEN_TEST, H),
                             check_generated_test(root / "data_test_big", N_GEN_TEST_BIG, BIG)]

    scores = {}
    for d_ in (None, "w"):
        args = get_args("eval", argv=["--data_path", str(root / "data_test"),
                                      "--model_path", str(w)])
        args.densify = d_
        with redirect_stdout(io.StringIO()):
            mods = load_inference_modules(args, densify=d_, device=dev)
        with counted(f"run_eval_{d_}"):
            res, log = run_loop(pipe.run_eval, args, mods, device=dev)
        read(f"run_eval_{d_}")
        check(launches[f"run_eval_{d_}"]["wedge_colors"] == N_GEN_TEST + 1
              and launches[f"run_eval_{d_}"]["wedge_render"] == N_GEN_TEST + 1
              and all(math.isfinite(v) for v in res.values()), f"run_eval {d_}: {res}")
        scores[f"run_eval_{d_}"] = res
    args = get_args("eval", big=True, argv=["--data_path", str(root / "data_test_big"),
                                            "--model_path", str(w)])
    with redirect_stdout(io.StringIO()):
        mods = load_inference_modules(args, big=True, device=dev)
    with counted("run_eval_big"):
        res, log = run_loop(pipe_big.run_eval_big, args, mods, device=dev)
    read("run_eval_big")
    per_call = -(-N_BLOCKS // args.block_chunk)
    check(launches["run_eval_big"]["wedge_colors"] == (N_GEN_TEST_BIG + 1) * per_call
          and all(math.isfinite(v) for v in res.values()), f"run_eval_big: {res}")
    scores["run_eval_big"] = res
    notes["scores"] = scores
    del mods
    notes["coco"] = run_coco_path(root, w, dev, counted, read)
    notes["densify"] = run_densify_path(root, data, w, dev, grid, patch_cfg, counted, read)
    print(f"densify notes: {notes['densify']}", flush=True)
    notes["parallel"] = run_dp_paths(root, w, dev)
    return launches, clock, notes



# --------------------------------------------------------------- the COCO source (7c)

# the committed fake MS-COCO / Painting fixture (make_coco_fixture.py); 4
# pairs at 147x147 and 2 at 587x587; nvJPEG's decodes against OpenCV's
# within bounds set from the first card run of this phase (PERF.md: at
# most 3 levels, 0.0183 on average, the IDCT's rounding through the
# colour conversion, on an H100 80GB HBM3 at 700 W)
COCO_FIXTURE = Path(__file__).resolve().parent / "tests" / "data" / "coco_fixture"
N_COCO, N_COCO_BIG, COCO_SEED = 4, 2, 1869
NVJPEG_MAX_ABS, NVJPEG_MEAN_ABS = 4, 0.05


def coco_decode_reading(dev) -> dict:
    """Every fixture JPEG decoded on the card (nvJPEG's YCbCr planes through
    libjpeg's upsampling and colour conversion, the path the loader takes)
    against OpenCV's decode (decoded_cv2/), max and mean |diff| per image,
    held to the bounds; every PNG bit for bit against OpenCV's (its SHA-256); one warm 640x480
    decode timed (CUDA events over 20 decodes, each ending in a stream
    synchronize)."""
    import hashlib

    from blurry_edges_tpu_torch.data import imageio

    out = {"jpeg": {}, "png": {}}
    for path in sorted(COCO_FIXTURE.glob("coco/val2017/*.jpg")) + sorted(
            COCO_FIXTURE.glob("painting/*.jpg")):
        tag = "val2017" if "val2017" in str(path) else "painting"
        want = imageio.decode_png((COCO_FIXTURE / "decoded_cv2" / f"{tag}_{path.stem}.png")
                                  .read_bytes()).astype(np.int16)
        got = imageio.imread(str(path), dev)
        check(tuple(got.shape) == want.shape, f"nvJPEG {path.name}: shape {tuple(got.shape)}, "
                                               f"OpenCV {want.shape}")
        d = np.abs(got.cpu().numpy().astype(np.int16) - want)
        out["jpeg"][f"{tag}/{path.name}"] = dict(max=int(d.max()),
                                                  mean=round(float(d.mean()), 5))
        check(d.max() <= NVJPEG_MAX_ABS and d.mean() <= NVJPEG_MEAN_ABS,
              f"nvJPEG {path.name} vs OpenCV: max {d.max()}, mean {d.mean():.4f}")
    hashes = json.loads((COCO_FIXTURE / "decoded_cv2" / "png_sha256.json").read_text())
    for key, (shape, digest) in hashes.items():
        folder = "coco/val2017" if key.startswith("val2017") else "painting"
        got = imageio.imread(str(COCO_FIXTURE / folder / key.split("/")[1]), dev).cpu().numpy()
        out["png"][key] = list(got.shape) == shape and hashlib.sha256(
            got.tobytes()).hexdigest() == digest
        check(out["png"][key], f"PNG {key} not OpenCV's pixels")
    data = (COCO_FIXTURE / "coco" / "val2017" / "000000000001.jpg").read_bytes()
    out["decode_640x480_ms"] = cuda_ms(lambda: imageio.decode_jpeg(data, dev, "640x480"), 20)
    return out


def run_coco_path(root: Path, w: Path, dev, counted, read) -> dict:
    """Phase 7c: the --coco test-set source on the card. Decode (above); the
    command line's gen_test --coco at 147x147 and --big --coco at 587x587 on
    the fixture, checked as the procedural sets are; the loader's masks,
    objects and backgrounds on the card against the CPU from the card's
    decoded arrays and the same picks (bit for bit), every mask non-empty,
    and the rendered clean images, from the same depth planes, within
    test_render_layer_card_vs_cpu's rtol 1e-4 / atol 1e-3; then run_eval
    (densify none and w) and run_eval_big over the sets with the weights
    phase 7b trained, each stage's launches counted from 0 just before it."""
    import random

    from blurry_edges_tpu_torch import cli
    from blurry_edges_tpu_torch.data import realistic_gen as rg
    from blurry_edges_tpu_torch.data import imageio
    from blurry_edges_tpu_torch.models.weights import load_inference_modules

    t0 = time.perf_counter()
    notes = {"decode": coco_decode_reading(dev), "nvjpeg_decodes": {}}
    frgd, bkgd = f"{COCO_FIXTURE}/coco/", f"{COCO_FIXTURE}/painting/"
    src = ["--coco", "--cuda", str(dev), "--frgd_path", frgd, "--bkgd_path", bkgd,
           "--data_path", str(root / "data_test_coco")]
    sets = {"gen_test_coco": ([], N_COCO, 147, root / "data_test_coco"),
            "gen_test_big_coco": (["--big"], N_COCO_BIG, BIG, root / "data_test_big_coco")}
    for stage, (flag, n, H, path) in sets.items():
        imageio.reset_launch_counts()
        with counted(stage):
            cli.gen_test_main(flag + src + ["--num_sample_test", str(n)])
        read(stage)
        notes["nvjpeg_decodes"][stage] = imageio.launch_counts()["nvjpeg_decode"]
        # the reference's composite (the blurred foreground, not clipped,
        # over the background times 1 - the clipped blurred mask) passes 255
        # where the mask's accumulated blur passes 1: clean counts may pass
        # alpha (the JAX package's too, tests/test_torch_coco.py)
        notes[f"{stage}_noise_z"] = check_generated_test(path, n, H, clean_le_alpha=False)
        gt = np.load(path / "images_gt.npy")
        notes[f"{stage}_clean_max_over_alpha"] = float(
            (gt / np.load(path / "alphas.npy")[:, None, None, None, None]).max())

        # the same picks on the card and on the CPU, from the card's decodes
        args = get_args("data_gen_test", argv=["--frgd_path", frgd, "--bkgd_path", bkgd])
        decoded = {}

        def card_read(p, device):
            decoded[p] = imageio.imread(p, device)
            return decoded[p]

        cpu_read = lambda p, device: decoded[p].cpu()                    # noqa: E731
        got = (*rg.load_coco_foregrounds(args, (H, H), n, random.Random(COCO_SEED), dev,
                                         imread=card_read),
               rg.load_painting_backgrounds(args, (H, H), n, np.random.RandomState(COCO_SEED),
                                            dev, imread=card_read))
        want = (*rg.load_coco_foregrounds(args, (H, H), n, random.Random(COCO_SEED), "cpu",
                                          imread=cpu_read),
                rg.load_painting_backgrounds(args, (H, H), n, np.random.RandomState(COCO_SEED),
                                             "cpu", imread=cpu_read))
        for name, g, c in zip(("masks", "objects", "backgrounds"), got, want):
            check(g.device == torch.device(dev) and torch.equal(g.cpu(), c),
                  f"{stage}: {name} differ between the card and the CPU")
        check(bool(got[0].flatten(1).any(1).all()), f"{stage}: an empty foreground mask")
        if H == 147:
            gen = rg.SyntheticRealisticDataGenerator(args, source="coco", device="cpu")
            g = torch.Generator().manual_seed(COCO_SEED)
            worst, own = 0.0, []
            lin = rg._linspace
            for i in range(n):
                draws = rg.draw_planes(g)
                d_bk, d_fg, _, _ = rg.planar_depths(draws["rel"], draws["angles"], H, H,
                                                    gen.z_lo, gen.z_hi)
                inputs = (d_bk, d_fg, want[0][i], want[2][i].float(), want[1][i].float())
                render = lambda *t: rg.render_image(*t, gen.cam, gen.mag, gen.K,   # noqa: E731
                                                    gen.n_interval)
                ref = render(*inputs)
                card_in = [t.to(dev) for t in inputs]
                with float32_precision():
                    mine = render(*card_in).cpu()
                    # the CPU's depth key points on the card too: the layer
                    # weights divide by their spacing, so one ulp of a key
                    # point moves a pixel by up to ~255 x 2 ulp / spacing
                    rg._linspace = lambda a, b, m: lin(a.cpu(), b.cpu(), m).to(a.device)
                    try:
                        img = render(*card_in).cpu()
                    finally:
                        rg._linspace = lin
                worst = max(worst, ((img - ref).abs() / (1e-3 + 1e-4 * ref.abs())).max().item())
                fg = d_fg[want[0][i]]
                spacing = min(float(d_bk.max() - d_bk.min()), float(fg.max() - fg.min())) / 150
                bound = 255 * 4 * float(np.spacing(np.float32(gen.z_hi))) / spacing
                own.append(((mine - ref).abs().max().item(), bound))
                check(own[-1][0] < bound, f"COCO render card vs CPU on the card's key points: "
                                          f"{own[-1][0]:.4f}, the key points' ulp bound {bound:.4f}")
            notes["render_card_vs_cpu_worst_over_tol"] = worst
            notes["render_card_key_points_max_vs_bound"] = own
            check(worst <= 1.0, f"COCO render card vs CPU: {worst:.3f} of rtol 1e-4 atol 1e-3")
        notes[f"{stage}_mask_px"] = got[0].flatten(1).sum(1).tolist()

    scores = {}
    for d_ in (None, "w"):
        args = get_args("eval", argv=["--data_path", str(root / "data_test_coco"),
                                      "--model_path", str(w)])
        args.densify = d_
        with redirect_stdout(io.StringIO()):
            mods = load_inference_modules(args, densify=d_, device=dev)
        with counted(f"run_eval_coco_{d_}"):
            res, _ = run_loop(pipe.run_eval, args, mods, device=dev)
        got = read(f"run_eval_coco_{d_}")
        check(got["wedge_colors"] == N_COCO + 1 and got["wedge_render"] == N_COCO + 1
              and all(math.isfinite(v) for v in res.values()), f"run_eval coco {d_}: {res}")
        scores[f"run_eval_coco_{d_}"] = res
    args = get_args("eval", big=True, argv=["--data_path", str(root / "data_test_big_coco"),
                                            "--model_path", str(w)])
    with redirect_stdout(io.StringIO()):
        mods = load_inference_modules(args, big=True, device=dev)
    with counted("run_eval_big_coco"):
        res, _ = run_loop(pipe_big.run_eval_big, args, mods, device=dev)
    got = read("run_eval_big_coco")
    per_call = -(-N_BLOCKS // args.block_chunk)
    check(got["wedge_colors"] == (N_COCO_BIG + 1) * per_call
          and got["wedge_render"] == (N_COCO_BIG + 1) * per_call
          and all(math.isfinite(v) for v in res.values()), f"run_eval_big coco: {res}")
    scores["run_eval_big_coco"] = res
    notes["scores"] = scores
    notes["seconds"] = time.perf_counter() - t0
    return notes


# --------------------------------------------------------------- step 0, densify, parallel

# the densify trainer on the chain's 64/32 scenes plus two realistic sets
# of 8 and 4 pairs: 3 epochs from the pipeline's sparse maps, then one
# epoch of simulated ones; the sparse maps' chunks timed over 32 pairs
N_REAL_TRAIN, N_REAL_VAL, DENSIFY_EPOCHS, SWEEP_PAIRS = 8, 4, 3, 32
SPARSE_CHUNKS = (4, 8, 16)
CNN_CPU_PATCHES = 2048     # patches of step 0's float64 reading also run on the CPU


@contextlib.contextmanager
def deterministic_algorithms():
    """torch.use_deterministic_algorithms(True) (warnings for ops that have
    no deterministic version, collected) and cudnn.deterministic, restored
    on exit. CUBLAS_WORKSPACE_CONFIG is set before the first cuBLAS call
    (main)."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            yield caught
        finally:
            torch.use_deterministic_algorithms(False)
            torch.backends.cudnn.deterministic = False


def local_args(data: Path, root: Path, tag: str, epochs: int = 2) -> argparse.Namespace:
    return get_args("local_train", argv=[
        "--data_path", str(data / "patches"), "--log_path", str(root / f"logs_local_{tag}"),
        "--model_path", str(root / f"w_local_{tag}"), "--epoch_num", str(epochs)])


def trained_local(data: Path, root: Path, tag: str, dev):
    """local_train for 2 epochs (as phase 7b's first call) from scratch:
    (curve, the trained state dict from the final snapshot)."""
    from blurry_edges_tpu_torch.train import local as tl
    from blurry_edges_tpu_torch.train.checkpoint import load_checkpoint

    res, _ = run_loop(tl.run_local_training, local_args(data, root, tag), snapshot_every=2,
                      resume=False, device=dev)
    return res["curve"], load_checkpoint(str(root / f"w_local_{tag}" / "last_exp_local_stage"))["model"]


def state_diff(a: dict, b: dict):
    """(bit-identical, max |diff|, the first tensor in module order that differs)."""
    first, worst = None, 0.0
    for k in a:
        d = (a[k].double() - b[k].double()).abs().max().item() if a[k].numel() else 0.0
        if d > 0 and first is None:
            first = k
        worst = max(worst, d)
    return first is None, worst, first


def determinism_reading(data: Path, root: Path, dev) -> dict:
    """Step 0, the first open fault: local_train (2 epochs) twice under
    deterministic algorithms and twice without, each pair's trained state
    dicts compared."""
    out, curves = {}, {}
    for mode in ("deterministic", "default"):
        states = []
        for i in range(2):
            ctx = deterministic_algorithms() if mode == "deterministic" else contextlib.nullcontext([])
            with ctx as caught:
                curve, sd = trained_local(data, root, f"{mode}{i}", dev)
            states.append(sd)
            curves[mode, i] = curve
            if mode == "deterministic" and i == 0:
                out["ops_without_deterministic_version"] = sorted(
                    {str(w.message).split(" does not have")[0][:80] for w in caught
                     if "deterministic" in str(w.message)})
        same, worst, first = state_diff(*states)
        out[mode] = dict(bit_identical=same, max_abs_diff=worst, first_differing=first,
                         val_curves=[curves[mode, 0].tolist(), curves[mode, 1].tolist()])
    return out


def cnn_float64_reading(w: Path, data: Path, grid: GridConfig, dev) -> dict:
    """Step 0, the second open fault: the chain's trained local stage in
    float32 against the same module cast to float64 on the card, over one
    precal device batch (8 pairs, 65,536 patches), TF32 off: p99 and max
    |diff| of the 10 raw outputs with cuDNN (the path precal and serving
    run) and, over the first 8,192 patches, with cuDNN off; and over the
    first 2,048 on the host's CPU, for scale."""
    from blurry_edges_tpu_torch.train.global_precal import load_local_stage

    with redirect_stdout(io.StringIO()):
        m32 = load_local_stage(str(w), dev)
    m64 = copy.deepcopy(m32).double()
    imgs = torch.from_numpy(
        np.load(data / "images_ny_train.npy", mmap_mode="r")[:PRECAL_BATCH]
        / np.load(data / "alphas_train.npy")[:PRECAL_BATCH, None, None, None, None]).float().to(dev)
    flat = unfold(imgs.reshape((-1,) + imgs.shape[2:]), grid.R, grid.stride)
    flat = flat.reshape(-1, grid.R, grid.R, 3).contiguous()
    out = {"patches": len(flat)}
    for label, n, cudnn_on in (("cudnn", len(flat), True), ("no_cudnn", min(8192, len(flat)),
                                                            False)):
        saved = torch.backends.cudnn.enabled
        torch.backends.cudnn.enabled = cudnn_on
        try:
            with torch.inference_mode(), float32_precision():
                d = torch.cat([(m32(x).double() - m64(x.double())).abs().flatten()
                               for x in flat[:n].split(4096)])
        finally:
            torch.backends.cudnn.enabled = saved
        out[label] = dict(patches=n, p99=d.kthvalue(int(0.99 * d.numel())).values.item(),
                          max=d.max().item())
    # the same module and patches on this host's CPU (oneDNN), for scale
    c32, c64, x = copy.deepcopy(m32).cpu(), copy.deepcopy(m64).cpu(), flat[:CNN_CPU_PATCHES].cpu()
    with torch.inference_mode():
        d = (c32(x).double() - c64(x.double())).abs().flatten()
    out["cpu"] = dict(patches=len(x), p99=d.kthvalue(int(0.99 * d.numel())).values.item(),
                      max=d.max().item())
    return out


def unet_step(dev, sparse, target, dtype=torch.float32):
    """One densify train step (train-mode BatchNorm, clip, AdamW) of the
    trainer's fresh U-Net (Flax's default init from its seed) on ``dev`` in
    ``dtype``: (loss, clipped gradients, update over lr, running
    statistics)."""
    from blurry_edges_tpu_torch.models.unet import UNet
    from blurry_edges_tpu_torch.train import densify as td
    from blurry_edges_tpu_torch.train.optim import flax_default_init

    model = UNet()
    flax_default_init(model, torch.Generator().manual_seed(td.SEED))
    model.to(device=dev, dtype=dtype)
    opt = make_optimizer(model.parameters(), 1e-4)
    before = [p.detach().clone() for p in model.parameters()]
    step, _ = td.make_steps(model, opt, grad_loss_w=0.5)
    loss = float(step(torch.from_numpy(sparse)[:, None].to(dev, dtype),
                      torch.from_numpy(target).to(dev, dtype)))
    grads = torch.cat([p.grad.detach().flatten().cpu() for p in model.parameters()]).double()
    upd = torch.cat([((p.detach() - b) / 1e-4).flatten().cpu()
                     for p, b in zip(model.parameters(), before)]).double()
    stats = torch.cat([b.detach().flatten().cpu() for n, b in model.named_buffers()
                       if n.endswith(("running_mean", "running_var"))]).double()
    return loss, grads, upd, stats


def unet_step_agreement(card, cpu, ref, card64) -> dict:
    """The card's float32 U-Net step and the CPU's against the CPU's
    float64 one (``ref``), and the card's float64 step (``card64``) against
    it. A gradient entry is clear where float64's lies 10x beyond both
    float32 gradients' distance to it and at least 100 Adam eps (1e-6), so
    Adam's first update there is the gradient's sign to ~1e-3 (41x41,
    batch 2: 86% of the entries on the CPU); the noise sets the line, not
    a share of the RMS, so no init is favoured."""
    (lc, gc, uc, sc), (lp, gp, up, sp), (lr, gr, ur, _) = card, cpu, ref
    noise = torch.maximum((gc - gr).abs(), (gp - gr).abs())
    clear = (gr.abs() > 10 * noise) & (gr.abs() >= 1e-6)
    rel = lambda g: ((g - gr).norm() / gr.norm()).item()  # noqa: E731
    return dict(loss_rel=abs(lc - lr) / abs(lr), grad_rel_l2=rel(gc), cpu_grad_rel_l2=rel(gp),
                f64_loss_rel=abs(card64[0] - lr) / abs(lr), f64_grad_rel_l2=rel(card64[1]),
                stats_max=(sc - sp).abs().max().item(),
                update_max_diff=(uc - ur).abs()[clear].max().item(),
                cpu_update_max_diff=(up - ur).abs()[clear].max().item(),
                update_max=(uc - ur).abs().max().item(),
                clear_share=clear.double().mean().item())


def unet_step_ok(a: dict) -> bool:
    """The card computes the CPU's step: in float64 the loss to 1e-10 and
    the gradient to 1e-8 (relative L2); in float32 the loss to 1e-4, the
    running statistics to the CPU's to 1e-5, updates on clear entries
    within 2e-3 of lr (over half the entries clear), every update within
    2 lr. The float32 gradients' distance to float64 is recorded: from
    this init the step is ill-conditioned (BatchNorm over the bottom's 2x2
    maps), and float32 implementations scatter from 3e-6 to 1e-3."""
    return (a["f64_loss_rel"] < 1e-10 and a["f64_grad_rel_l2"] < 1e-8
            and a["loss_rel"] < 1e-4 and a["stats_max"] < 1e-5
            and a["update_max_diff"] < 2e-3 and a["update_max"] <= 2.0
            and a["clear_share"] > 0.5)


def run_densify_path(root: Path, data: Path, w: Path, dev, grid, patch_cfg, counted, read):
    """The densify trainer (the eighth slice) on the chain's weights and
    scenes: the pipeline source with two realistic sets, then the simulated
    source; its checkpoint served as densify pp; the first 4 sparse maps
    card vs CPU; one U-Net step card vs CPU at 41x41; sparse maps/s at
    chunks 4, 8, 16; ms a train step. Returns its notes."""
    from blurry_edges_tpu_torch import cli
    from blurry_edges_tpu_torch.train import densify as td
    from blurry_edges_tpu_torch.models.weights import load_inference_modules

    notes = {}
    for name, n in (("real_train", N_REAL_TRAIN), ("real_val", N_REAL_VAL)):
        with redirect_stdout(io.StringIO()):
            cli.gen_test_main(["--cuda", str(dev), "--data_path", str(root / name),
                               "--num_sample_test", str(n), "--img_size", str(grid.H),
                               str(grid.W)])
    dargs = get_args("local_train", argv=["--data_path", str(data), "--model_path", str(w),
                                          "--log_path", str(root / "logs_densify")])
    with redirect_stdout(io.StringIO()):
        mods = load_inference_modules(dargs, device=dev)
    with counted("densify_pipeline"):
        res, log = run_loop(td.run_densify_training, dargs, epochs=DENSIFY_EPOCHS,
                            source="pipeline", modules=mods,
                            realistic_dirs=(str(root / "real_train"), str(root / "real_val")),
                            device=dev)
    got = read("densify_pipeline")
    calls = sum(-(-n // td.SPARSE_CHUNK) for n in (N_GEN_TRAIN, N_GEN_VAL, N_REAL_TRAIN,
                                                   N_REAL_VAL))
    check(got["wedge_colors"] == got["wedge_render"] == calls and got["flash_fwd"] == 0,
          f"densify pipeline launches {got}, want {calls} of each wedge kernel")
    check(np.isfinite(res["curve"]).all() and res["curve"].shape == (DENSIFY_EPOCHS,)
          and (res["n_train"], res["n_val"]) == (N_GEN_TRAIN + N_REAL_TRAIN,
                                                 N_GEN_VAL + N_REAL_VAL)
          and checkpoint_exists(str(w / "best_run_exp_depth_completion_pp")),
          f"densify pipeline: {res}")
    notes["pipeline"] = {k: res[k] for k in ("curve", "sparse_seconds", "epoch_seconds",
                                             "steps", "n_train", "n_val")}
    sargs = copy.copy(dargs)
    sargs.model_path, sargs.log_path = str(root / "w_sim"), str(root / "logs_densify_sim")
    with counted("densify_simulated"):
        sim, _ = run_loop(td.run_densify_training, sargs, epochs=1, source="simulated",
                          device=dev)
    got = read("densify_simulated")
    check(np.isfinite(sim["curve"]).all() and got["wedge_colors"] == got["wedge_render"] == 0
          and checkpoint_exists(str(root / "w_sim" / "best_run_exp_depth_completion_pp")),
          f"densify simulated: {sim['curve']}, launches {got}")
    notes["simulated"] = {k: sim[k] for k in ("curve", "epoch_seconds", "steps")}

    # the checkpoint served: densify pp through load_inference_modules
    eargs = get_args("eval", argv=["--model_path", str(w)])
    with redirect_stdout(io.StringIO()) as seen:
        served = load_inference_modules(eargs, densify="pp", device=dev)
    check(str(w / "best_run_exp_depth_completion_pp.pth") in seen.getvalue(),
          "densify pp did not load the trained checkpoint")
    pair = (np.load(root / "data_test" / "images_ny.npy")[0]
            / np.load(root / "data_test" / "alphas.npy")[0]).astype(np.float32)
    out = make_depth_estimator(served, patch_cfg, grid, CamConfig(), densify="pp",
                               device=dev)(pair)
    check(tuple(out["depth_final"].shape) == (1, grid.H, grid.W)
          and torch.isfinite(out["depth_final"]).all().item(), "densify pp serving")
    del served

    # the first 4 sparse maps, card against the CPU port (0.05 confidence
    # threshold: knife edges flip a few pixels between 0 and a depth)
    card_maps = td._pipeline_sparse_depths(dargs, "train", mods, 4, chunk=4, device=dev)
    with redirect_stdout(io.StringIO()):
        cpu_mods = load_inference_modules(dargs, device="cpu")
    cpu_maps = td._pipeline_sparse_depths(dargs, "train", cpu_mods, 4, chunk=4, device="cpu")
    d = np.abs(card_maps - cpu_maps)
    far = float((d > 5e-3).mean())
    check(far <= 0.02 and (cpu_maps > 0).any(),
          f"sparse maps card vs CPU: {far} of the entries apart by more than 5e-3")
    notes["sparse_vs_cpu"] = dict(far_share=far, max_abs=float(d.max()),
                                  p99_abs=float(np.quantile(d, 0.99)))

    # one U-Net train step at 41x41, card against CPU, float32 and float64
    r = np.random.default_rng(SEED + 21)
    tgt = r.uniform(0.75, 1.18, (2, 41, 41)).astype(np.float32)
    sp = np.where(r.uniform(size=tgt.shape) < 0.4, tgt, 0.0).astype(np.float32)
    step_agree = unet_step_agreement(unet_step(dev, sp, tgt), unet_step("cpu", sp, tgt),
                                     unet_step("cpu", sp, tgt, torch.float64),
                                     unet_step(dev, sp, tgt, torch.float64))
    check(unet_step_ok(step_agree), f"U-Net step card vs CPU: {step_agree}")
    notes["unet_step_vs_cpu"] = step_agree

    # sparse maps/s by chunk, 32 train pairs each after a warm-up call
    rates = {}
    for c in SPARSE_CHUNKS:
        td._pipeline_sparse_depths(dargs, "train", mods, c, chunk=c, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        td._pipeline_sparse_depths(dargs, "train", mods, SWEEP_PAIRS, chunk=c, device=dev)
        torch.cuda.synchronize()
        rates[c] = SWEEP_PAIRS / (time.perf_counter() - t0)
    notes["sparse_maps_per_s"] = rates
    del mods

    # ms a train step at batch 8, 147x147 (the trainer's step), and its peak
    model, opt = td.init_state(1e-4, dev)
    step, _ = td.make_steps(model, opt)
    depth = torch.from_numpy(np.load(data / "image_depths_train.npy")[:8]).to(dev)
    sp8 = torch.where(torch.rand(depth.shape, device=dev) > 0.6, depth, 0.0)[:, None]
    step(sp8, depth)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(5):
        step(sp8, depth)
    torch.cuda.synchronize()
    notes["train_step_ms"] = (time.perf_counter() - t0) / 5 * 1e3
    notes["train_step_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del model, opt, step
    torch.cuda.empty_cache()
    return notes


def eval_maps_collector():
    maps = {}
    return maps, lambda j, img, gt, out: maps.setdefault(j, out)


def dp_ws1_rank(root: str, w: str, device: str = "cuda:0") -> dict:
    """World size 1 (under NCCL on the card): the four modes' data-parallel
    paths through the command line, inside a rank; each mode's result and
    launches."""
    from blurry_edges_tpu_torch import cli

    root, cuda, out = Path(root), ["--cuda", device], {}
    modes = {
        "local_train": (cli.local_train_main, cuda + [
            "--data_path", str(root / "data" / "patches"), "--log_path",
            str(root / "logs_dp1_local"), "--model_path", str(root / "w_dp1"),
            "--epoch_num", "2"]),
        "global_train": (cli.global_train_main, cuda + [
            "--data_path", str(root / "data"), "--log_path", str(root / "logs_dp1_global"),
            "--model_path", str(root / "w_dp1"), "--epoch_num", "1", "--attn_impl", "flash",
            "--train_subset", "16", "--val_batches", "1"]),
        "eval": (cli.eval_main, cuda + ["--data_path", str(root / "data_test"),
                                        "--model_path", w, "--log_path", str(root / "logs_dp1")]),
        "eval_big": (cli.eval_big_main, cuda + [
            "--data_path", str(root / "data_test_big"), "--model_path", w,
            "--log_path", str(root / "logs_dp1_big"), "--vis_max", "1"])}
    for name, (fn, argv) in modes.items():
        fa.reset_launch_counts()
        wedge_cuda.reset_launch_counts()
        res, _ = run_loop(fn, argv)
        if name == "global_train":
            res = np.load(root / "logs_dp1_global" / "loss_curve_exp_global_stage.npy")
        out[name] = dict(result=res, launches={**wedge_cuda.launch_counts(),
                                               **fa.launch_counts()})
    return out


def dp_ws2_args(root: Path, w: Path, tag: str):
    gargs = get_args("global_train", argv=[
        "--data_path", str(root / "data"), "--log_path", str(root / f"logs_{tag}_global"),
        "--model_path", str(root / f"w_{tag}"), "--epoch_num", "1", "--attn_impl", "flash",
        "--train_subset", "16", "--val_batches", "1"])
    eargs = get_args("eval", argv=["--data_path", str(root / "data_test"), "--model_path", str(w)])
    bargs = get_args("eval", big=True, argv=["--data_path", str(root / "data_test_big"),
                                             "--model_path", str(w)])
    return gargs, eargs, bargs


def dp_paths(root: Path, w: Path, mesh=None, dev=None, only_global=False) -> dict:
    """local_train (2 epochs, deterministic algorithms), global_train (one
    short flash epoch: 2 steps, 1 val batch), run_eval (3 pairs) and
    run_eval_big (1 pair, its maps) under ``mesh`` (a rank's) or in one
    process on ``dev``."""
    from blurry_edges_tpu_torch.train import local as tl
    from blurry_edges_tpu_torch.models.weights import load_inference_modules

    dev = mesh.device if mesh is not None else dev
    tag = "dp2" if mesh is not None else "one"
    gargs, eargs, bargs = dp_ws2_args(root, w, tag)
    out = {}
    if only_global:
        gargs.log_path, gargs.model_path = gargs.log_path + "_again", gargs.model_path + "_again"
    with deterministic_algorithms():
        if not only_global:
            out["local_train"] = run_loop(tl.run_local_training,
                                          local_args(root / "data", root, tag), snapshot_every=0,
                                          resume=False, device=dev, mesh=mesh)[0]["curve"]
        run_loop(tg.run_global_training, gargs, device=dev, mesh=mesh)
    out["global_train"] = np.load(Path(gargs.log_path) / "loss_curve_exp_global_stage.npy")
    if only_global:
        return out
    with redirect_stdout(io.StringIO()):
        mods = load_inference_modules(eargs, device=dev)
        mods_big = load_inference_modules(bargs, big=True, device=dev)
    out["eval"] = run_loop(pipe.run_eval, eargs, mods, device=dev, mesh=mesh)[0]
    maps, vis = eval_maps_collector()
    out["eval_big"] = run_loop(pipe_big.run_eval_big, bargs, mods_big, visualizer=vis,
                               max_images=1, device=dev, mesh=mesh)[0]
    out["big_maps"] = maps.get(0)
    return out


def local_first_step(root: Path, dev, mesh=None):
    """The local trainer's first step (epoch 0's first batch, the trainer's
    init) under ``mesh`` (each rank on its share of the global batch) or in
    one process: (global loss, clipped gradients, update over lr)."""
    from blurry_edges_tpu_torch.config import patch_from_args
    from blurry_edges_tpu_torch.data.datasets import BatchIterator, ShapeDataset
    from blurry_edges_tpu_torch.parallel import mesh as pm
    from blurry_edges_tpu_torch.train import local as tl

    mesh = mesh or pm.make_mesh(device=dev)
    args = local_args(root / "data", root, "step")
    ds = ShapeDataset(args.data_path, train=True, mode="local")
    rows = pm.data_sharding(len(ds), mesh)
    shard = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
             for k, v in ds.batch(np.arange(rows.start, rows.stop)).items()}
    idx = next(iter(BatchIterator(len(ds), args.batch_size, shuffle=True, seed=tl.SEED)))
    share = pm.data_sharding(args.batch_size, mesh)
    batch = {k: v[share] for k, v in pm.gather_rows(shard, rows.start, idx, mesh).items()}
    model, opt = tl.init_state(tl.SEED, args.learning_rate, dev)
    before = [p.detach().clone() for p in model.parameters()]
    step, _ = tl.make_step_fns(model, opt, patch_from_args(args), mesh)
    with deterministic_algorithms():
        loss = pm.all_reduce(step(batch, (0.0, 0.0)).clone(), mesh) / mesh.size
    grads = torch.cat([p.grad.flatten().cpu() for p in model.parameters()]).double()
    upd = torch.cat([((p.detach() - b) / args.learning_rate).flatten().cpu()
                     for p, b in zip(model.parameters(), before)]).double()
    return float(loss), grads, upd


def global_first_step(root: Path, dev, mesh=None, trainer_init=False, seed=0):
    """The global trainer's first step on the first batch of epoch 0's
    shuffle from fresh_model's init (dropout 0, the generator scaled by
    1/4: the well-conditioned start of the step comparisons) or, with
    ``trainer_init``, from the trainer's own (init_state, dropout 0.1),
    4 chunks of 2 (2 a rank under ``mesh``), dropout drawn from ``seed``:
    (global loss, clipped gradients, update over lr)."""
    from blurry_edges_tpu_torch.data.datasets import BatchIterator
    from blurry_edges_tpu_torch.parallel import mesh as pm

    mesh = mesh or pm.make_mesh(device=dev)
    arrays = tg.load_global_compact(str(root / "data"), train=True, subset=16)
    rows = pm.data_sharding(16, mesh)
    shard = tg.to_device_batch({k: v[rows] for k, v in arrays.items()}, dev, bf16_tokens=True)
    idx = next(iter(BatchIterator(16, BATCH, shuffle=True, seed=1898)))
    share = pm.data_sharding(BATCH, mesh)
    batch = {k: v[share] for k, v in pm.gather_rows(shard, rows.start, idx, mesh).items()}
    if trainer_init:
        model = GlobalStage(attn_impl="flash").to(dev)
        tg.init_state(model, 1898, LR)
    else:
        model = fresh_model("flash", N_LAYERS, dev)
    before = [p.detach().clone() for p in model.parameters()]
    H = arrays["imgs_u8"].shape[2]
    patch_cfg, grid = PatchConfig(), GridConfig(H=H, W=H)
    step, _ = tg.make_step_fns(model, make_optimizer(model.parameters(), LR), patch_cfg, grid,
                               DfDSolver.from_config(CamConfig(), patch_cfg),
                               CHUNKS // mesh.size, mesh=mesh)
    loss = float(step(batch, tg.gammas_to_array(GAMMAS, dev), seed))
    grads = torch.cat([p.grad.flatten().cpu() for p in model.parameters()]).double()
    upd = torch.cat([((p.detach() - b) / LR).flatten().cpu()
                     for p, b in zip(model.parameters(), before)]).double()
    return loss, grads, upd


# the global trainer's first step's dropout seed (run_global_training)
TRAINER_STEP_SEED = fold_in(fold_in(1898, 0), 0)


def dp_ws2_rank(root: str, w: str) -> dict:
    from blurry_edges_tpu_torch.parallel import make_mesh

    mesh = make_mesh(2)
    out = dp_paths(Path(root), Path(w), mesh=mesh)
    out["local_step"] = local_first_step(Path(root), mesh.device, mesh)
    out["global_step"] = global_first_step(Path(root), mesh.device, mesh)
    out["global_step_dropout"] = global_first_step(Path(root), mesh.device, mesh,
                                                   trainer_init=True, seed=TRAINER_STEP_SEED)
    return out


@contextlib.contextmanager
def rows_reversed():
    """The trainers' batches with their rows in reverse order: the same
    sums in another float order (the local stage has no dropout)."""
    from blurry_edges_tpu_torch.data import datasets

    base = datasets.BatchIterator

    class Reversed(base):
        def __iter__(self):
            for idx in super().__iter__():
                yield idx[::-1].copy()

    datasets.BatchIterator = Reversed
    try:
        yield
    finally:
        datasets.BatchIterator = base


def float_order_witnesses(root: Path, dev) -> dict:
    """One process, changed only at float32's last bits: local_train (2
    epochs) on batches whose rows are reversed, and the global trainer's
    short flash epoch from its own init moved 1-2 ulps (each parameter
    times 1 +- 2^-22, through --init_from). Their curves, for the drift
    they show beside world size 2's."""
    from blurry_edges_tpu_torch.train import local as tl
    from blurry_edges_tpu_torch.train.checkpoint import save_checkpoint

    with deterministic_algorithms(), rows_reversed():
        local = run_loop(tl.run_local_training, local_args(root / "data", root, "rev"),
                         snapshot_every=0, resume=False, device=dev)[0]["curve"]
    gargs = dp_ws2_args(root, root, "ulp")[0]
    model = GlobalStage(in_parameter_size=gargs.input_size,
                        out_parameter_size=gargs.output_size)
    tg.init_state(model, 1898, gargs.learning_rate)
    g = torch.Generator().manual_seed(SEED)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1 + 2.0 ** -22 * (2 * torch.randint(0, 2, p.shape, generator=g) - 1))
    gargs.init_from = save_checkpoint(str(root / "w_ulp" / "init"), model.state_dict())
    with deterministic_algorithms():
        run_loop(tg.run_global_training, gargs, device=dev)
    return dict(local_train=local,
                global_train=np.load(Path(gargs.log_path) / "loss_curve_exp_global_stage.npy"))


def run_dp_paths(root: Path, w: Path, dev) -> dict:
    """Data parallelism on the card: world size 1 under NCCL through the
    four modes' command lines, then world size 2 under gloo with both ranks
    on cuda:0, each of its paths against one process on the same inputs
    (both sides under deterministic algorithms): the global trainer's first
    step as compare_steps holds the card's steps; the local trainer's first
    step (loss to 1e-5, clipped gradients to a relative L2 error of 1e-2,
    Adam's first update within 2e-3 of lr where the gradient is at least
    0.1 of its RMS but for under 1e-5 of those entries: the loss's gradient
    moves by ~3e-3 for a float32-level change of the CNN's output, as
    between the two packages in tests/test_torch_train_local.py, and a rare
    entry flips sign); both curves printed (one process repeats its global
    curve bit for bit); run_eval's and run_eval_big's metrics within 1e-3
    and the 587x587 maps as batched vs single serving. No speed is claimed:
    one card."""
    from blurry_edges_tpu_torch.parallel import launch

    notes = {}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ws1 = launch(dp_ws1_rank, 1, backend="nccl", devices=["cuda:0"], args=(str(root), str(w)),
                 timeout=600)[0]
    notes["ws1_seconds"] = time.perf_counter() - t0
    check(np.isfinite(ws1["local_train"]["result"]["curve"]).all()
          and np.isfinite(ws1["global_train"]["result"]).all()
          and all(math.isfinite(ws1[k]["result"][m]) for k in ("eval", "eval_big")
                  for m in ("delta1", "rmse")), f"world size 1 under NCCL: {ws1}")
    per_call = -(-N_BLOCKS // BLOCK_CHUNK)
    want = {"eval": N_GEN_TEST + 1, "eval_big": (N_GEN_TEST_BIG + 1) * per_call}
    for k, n in want.items():
        got = ws1[k]["launches"]
        check(got["wedge_colors"] == got["wedge_render"] == n,
              f"world size 1 {k}: launches {got}, want {n} of each wedge kernel")
    steps = 16 // BATCH
    want_flash = {k: steps * STEP_LAUNCHES[k] + VAL_BATCH_LAUNCHES[k] for k in STEP_LAUNCHES}
    got_flash = {k: ws1["global_train"]["launches"][k] for k in STEP_LAUNCHES}
    check(got_flash == want_flash, f"world size 1 global_train flash {got_flash}, want {want_flash}")
    notes["ws1"] = {k: v["launches"] for k, v in ws1.items()}

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        two = launch(dp_ws2_rank, 2, backend="gloo", devices=["cuda:0", "cuda:0"],
                     args=(str(root), str(w)), timeout=900)
    except RuntimeError as e:
        raise CheckFailed(f"world size 2 under gloo on cuda:0 failed (a collective gloo "
                          f"refuses on CUDA tensors shows in the rank's traceback): {e}")
    notes["ws2_seconds"] = time.perf_counter() - t0
    one = dp_paths(root, w, dev=dev)
    agree = {}
    for k in ("local_train", "global_train"):
        a, b = two[0][k], one[k]
        agree[k] = dict(max_rel=float(np.max(np.abs(a - b) / np.abs(b))), curve=a.tolist(),
                        one=b.tolist())
        check(np.isfinite(a).all() and a.shape == b.shape, f"world size 2 {k}: curve {a}")
    # the curves drift over their few steps by float order (the ranks sum
    # the chunks' gradients in another order) amplified by the losses'
    # conditioning and Adam's sign-like first steps: printed, and each
    # trainer's first step held. One process repeats its global curve bit
    # for bit (as step 0's deterministic local runs)
    again = dp_paths(root, w, dev=dev, only_global=True)["global_train"]
    agree["global_train"]["one_repeats"] = bool(np.array_equal(again, one["global_train"]))
    check(agree["global_train"]["one_repeats"], f"global_train one process: {again} then "
          f"{one['global_train']}")
    agree["global_step"] = compare_steps(two[0]["global_step"], global_first_step(root, dev),
                                         "world size 2 global_train first step")
    # the trainer's own init and first step, dropout on: the ranks draw the
    # masks one process draws (a mask drawn from another seed moves the
    # loss far beyond the limit: the control)
    (la, ga, _), (lb, gb, _) = two[0]["global_step_dropout"], global_first_step(
        root, dev, trainer_init=True, seed=TRAINER_STEP_SEED)
    lc = global_first_step(root, dev, trainer_init=True, seed=TRAINER_STEP_SEED + 1)[0]
    agree["global_step_dropout"] = dict(loss_rel=abs(la - lb) / abs(lb),
                                        grad_rel_l2=((ga - gb).norm() / gb.norm()).item(),
                                        other_seed_loss_rel=abs(lc - lb) / abs(lb))
    check(agree["global_step_dropout"]["loss_rel"] < 1e-5
          and agree["global_step_dropout"]["grad_rel_l2"] < 1e-2
          and agree["global_step_dropout"]["other_seed_loss_rel"] > 1e-5,
          f"world size 2 global_train first step, dropout on: {agree['global_step_dropout']}")
    # the curves' drift beside one process's own under a float-order change
    wit = float_order_witnesses(root, dev)
    for k in ("local_train", "global_train"):
        b = one[k]
        agree[k]["witness_max_rel"] = float(np.max(np.abs(wit[k] - b) / np.abs(b)))
        agree[k]["witness_curve"] = wit[k].tolist()
    (la, ga, ua), (lb, gb, ub) = two[0]["local_step"], local_first_step(root, dev)
    d = (ua - ub).abs()
    clear = gb.abs() >= 0.1 * gb.square().mean().sqrt()
    agree["local_step"] = dict(loss_rel=abs(la - lb) / abs(lb),
                               grad_rel_l2=((ga - gb).norm() / gb.norm()).item(),
                               apart_share=(d[clear] > 2e-3).double().mean().item(),
                               clear_share=clear.double().mean().item())
    check(agree["local_step"]["loss_rel"] < 1e-5 and agree["local_step"]["grad_rel_l2"] < 1e-2
          and agree["local_step"]["apart_share"] < 1e-5 and d.max().item() <= 2.0,
          f"world size 2 local_train first step: {agree['local_step']}")
    for k in ("eval", "eval_big"):
        diff = max(abs(two[0][k][m] - one[k][m]) for m in ("delta1", "delta2", "delta3",
                                                            "rmse", "absrel"))
        agree[k] = dict(max_metric_diff=diff, delta1=two[0][k]["delta1"])
        check(diff < 1e-3 and two[1][k] is None, f"world size 2 {k}: {two[0][k]} vs {one[k]}")
    for k, v in one["big_maps"].items():
        dd = np.abs(two[0]["big_maps"][k] - v).ravel()
        check(np.quantile(dd, 0.8) < 1e-3 and (dd > 0.01).mean() < 0.05,
              f"world size 2 eval_big map {k}")
    notes["ws2_vs_one"] = agree
    return notes


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 2
    # step 0's deterministic runs need it before the first cuBLAS call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("setup: TF32 off for matmuls and cuDNN convolutions (float32 throughout); "
          f"CUBLAS_WORKSPACE_CONFIG={os.environ['CUBLAS_WORKSPACE_CONFIG']}")
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}")
    t_start = time.perf_counter()

    # 1. build: every source by its own nvcc, all started together
    lib = load_library()
    regs = [ln.strip() for ln in lib.log.splitlines() if "registers" in ln]
    print(f"build: {lib.build_seconds:.2f} s for the six kernels of "
          f"{len(lib.log.split('== ')) - 1} sources -> {lib.path.name}; ptxas: {regs}")
    for name, source in TENSOR_CORE_KERNELS.items():
        print(f"ptxas {name} ({source}): {ptxas_line(lib.log, source)}")
    print(f"ptxas wedge_colors (wedge_colors.cu), the R = 21 instance: "
          f"{ptxas_line(lib.log, 'wedge_colors.cu', 'ILi21E')}; dynamic shared memory "
          f"{lib.cdll.wedge_colors_smem_bytes(PatchConfig().R)} B a block")
    print(f"ptxas wedge_render (wedge_render.cu): {ptxas_line(lib.log, 'wedge_render.cu')}; "
          f"dynamic shared memory {lib.cdll.wedge_render_smem_bytes(PatchConfig().R)} B a block")
    mma_counts = tensor_core_counts(lib.path, list(TENSOR_CORE_KERNELS))
    print(f"sass: tensor-core instructions (HMMA/HGMMA) by kernel {mma_counts}")
    for name, n in mma_counts.items():
        check(n > 0, f"{name}: no tensor-core instruction in its SASS")

    # 2. each kernel against its plain version at the main path's shapes
    patch_cfg, cam, grid = PatchConfig(), CamConfig(), GridConfig()
    dfd = DfDSolver.from_config(cam, patch_cfg)
    R, Hp, L = grid.R, grid.H_patches, grid.num_tokens
    gen = torch.Generator().manual_seed(SEED)
    mods = random_modules(gen, dev, unet=True)
    rng = np.random.default_rng(SEED)
    pairs = make_pairs(rng, N_PAIRS, grid.H)

    with torch.inference_mode():
        one = path_inputs(mods, pairs[:1], patch_cfg, grid, dev)    # 8,192 / 4,096 patches
        four = path_inputs(mods, pairs, patch_cfg, grid, dev)       # 32,768 / 16,384 patches
        params, flat, xy, etas = one["params"], one["flat"], one["xy"], one["etas"]
        img_patches = one["img_patches"]

        zero_params = torch.zeros_like(params)
        zero_params[:, 8:] = 2.0

        errs = {"wedge_colors": 0.0, "wedge_render": 0.0}
        colors_cases = [("single-pair path", params, flat),
                        (f"batched path x{N_PAIRS}", four["params"], four["flat"]),
                        ("degenerate", zero_params, flat),
                        ("ragged", params[:8191], flat[:8191])]
        # the pixels' start moved by 1 to 3 floats: with the 5,292-byte
        # patches, every patch's start lands in each 4-byte class of 16
        for off in (1, 2, 3):
            buf = torch.empty(4097 * R * R * 3 + off, device=dev)
            shifted = buf[off:].view(4097, R, R, 3)
            shifted.copy_(flat[:4097])
            colors_cases.append((f"start +{off} floats", params[:4097], shifted))
        for case, p, f in colors_cases:
            e = compare_colors(wedge_cuda.wedge_colors(p, f, patch_cfg),
                               wedge_cuda.wedge_colors_plain(p, f, patch_cfg))
            errs["wedge_colors"] = max(errs["wedge_colors"], e)
            print(f"kernel wedge_colors vs plain [{case}, P={p.shape[0]}]: max|diff| {e:.3g} ok")
        render_cases = (
            ("single-pair path", xy, etas, img_patches),
            (f"batched path x{N_PAIRS}", four["xy"], four["etas"], four["img_patches"]),
            ("random geometry", *random_render_inputs(1, Hp, Hp, R, SEED + 1, dev)[:2],
             img_patches),
            (f"random geometry x{N_PAIRS}",
             *random_render_inputs(N_PAIRS, Hp, Hp, R, SEED + 3, dev)[:2], four["img_patches"]),
            ("degenerate", torch.zeros_like(xy), torch.full_like(etas, 0.01), img_patches),
            # ragged: the 587x587 path's 41x41 blocks, 11x11 patches each
            ("ragged 11x11 grid x3", *random_render_inputs(3, 11, 11, R, SEED + 5, dev)))
        for case, x_, e_, ip in render_cases:
            for hard in (False, True):
                args = (x_, e_, ip, patch_cfg, dfd, RHO_PRIME, hard)
                e = compare_render(wedge_cuda.wedge_render(*args),
                                   wedge_cuda.wedge_render_plain(*args))
                errs["wedge_render"] = max(errs["wedge_render"], e)
                print(f"kernel wedge_render vs plain [{case}, hard={hard}, "
                      f"B={x_.shape[0]}, P={x_.shape[0] * x_.shape[1] * x_.shape[2]}]: "
                      f"max|diff| {e:.3g} ok")
        # the 587x587 path's chunk shapes: a chunk of c blocks is one colors
        # launch over c x 8,192 patches and one render launch over c blocks
        big_ms = {}
        for c in BIG_CHUNKS:
            big_in = big_kernel_inputs(four, c, dev)
            e_c, e_r = compare_big(*big_in, patch_cfg, dfd)
            errs["wedge_colors"] = max(errs["wedge_colors"], e_c)
            errs["wedge_render"] = max(errs["wedge_render"], e_r)
            p_, f_, x_, e_, i_ = big_in
            big_ms["wedge_colors", c] = cuda_ms(
                lambda: wedge_cuda.wedge_colors(p_, f_, patch_cfg), 10)
            big_ms["wedge_render", c] = cuda_ms(
                lambda: wedge_cuda.wedge_render(x_, e_, i_, patch_cfg, dfd, RHO_PRIME, False), 10)
            print(f"kernels at the 587x587 path's chunk of {c} blocks (colors P={p_.shape[0]}, "
                  f"render B={c}, soft masks) vs plain, 4 blocks at a time: max|diff| colors "
                  f"{e_c:.3g}, render {e_r:.3g} ok")
            del big_in, p_, f_, x_, e_, i_
            torch.cuda.empty_cache()
        del four
        torch.cuda.synchronize()

        # the flash kernels at a training chunk's shape and at a ragged L
        # (the 41x41 grid's 121 tokens)
        for shape in (FLASH_SHAPE, (1, 8, 121, 16)):
            case = compare_flash(shape, SEED + shape[2], dev)
            for name, e in case.items():
                errs[name] = max(errs.get(name, 0.0), e)
            print(f"kernels flash_fwd, flash_bwd_dkv, flash_bwd_dq vs plain [{shape}]: "
                  f"max|diff| " + ", ".join(f"{k} {e:.3g}" for k, e in case.items()) + " ok")

    # the LocalStage's tail kernel at the ten junctions, 8,192 and 32,768 patches
    ep = check_epilogue(dev)
    print("kernel local_epilogue vs plain [10 junctions x 8,192 and 32,768 patches]: fresh "
          "statistics equal to the bit; random ones in float32 ulps of the size, kernel from "
          f"exact {ep['errs']['exact']:.3f}, from cuDNN's BatchNorm {ep['errs']['cudnn']:.3f}, "
          f"cuDNN's from exact {ep['errs']['cudnn_exact']:.3f} ok")

    # 3. serving: each path's launches counted from 0 just before it
    single = {d: make_depth_estimator(mods, patch_cfg, grid, cam, densify=d,
                                      rho_prime=RHO_PRIME, device=dev)
              for d in DENSIFY}
    batched = {d: make_batched_depth_estimator(mods, patch_cfg, grid, cam, densify=d,
                                               rho_prime=RHO_PRIME, device=dev)
               for d in DENSIFY}
    H = grid.H
    shapes = dict(global_image=(2, H, H, 3), global_shpd=(H, H, 3), global_refoc=(H, H, 3),
                  global_bndry=(H, H), global_depth=(H, H), confidence=(H, H),
                  depth_final=(H, H))
    # local_epilogue's launches and the LocalStage's forwards by path
    outs, out_b, launches_by_path, le_by_path = {}, {}, {}, {}
    for d, fn in single.items():
        wedge_cuda.reset_launch_counts()
        with counting_epilogue(mods.local_model, le_by_path, f"single_{d}", 10):
            outs[d] = [fn(p) for p in pairs]
        torch.cuda.synchronize()
        launches_by_path[f"single_{d}"] = wedge_cuda.launch_counts()
    for d, fn in batched.items():
        wedge_cuda.reset_launch_counts()
        with counting_epilogue(mods.local_model, le_by_path, f"batched_{d}", 10):
            out_b[d] = fn(np.stack(pairs))
        torch.cuda.synchronize()
        launches_by_path[f"batched_{d}"] = wedge_cuda.launch_counts()
    print(f"serving: single-pair paths, {N_PAIRS} calls each, and batched paths, 1 call of "
          f"{N_PAIRS} pairs each (densify {', '.join(map(str, DENSIFY))}): launches "
          f"{launches_by_path}; local_epilogue launches and LocalStage forwards {le_by_path}")
    # once a call: a single-pair call is one pair, the batched call's one
    # launch covers its 4 pairs; the pp paths as the others
    for path, got in launches_by_path.items():
        n = N_PAIRS if path.startswith("single") else 1
        check(got == {"wedge_colors": n, "wedge_render": n},
              f"{path} launches {got}, want {n} of each")
    for d, res in outs.items():
        for out in res:
            for k, shp in shapes.items():
                check(tuple(out[k].shape) == (1,) + shp, f"{k} shape {tuple(out[k].shape)}")
                check(torch.isfinite(out[k]).all().item(), f"densify {d}: {k} not finite")
            # a randomly weighted U-Net's map has no sign to check, only variation
            check((out["depth_final"].std() > 0 if d == "pp" else out["depth_final"] > 0)
                  .any().item(), f"densify {d}: no depth predicted")
    for d, ob in out_b.items():
        for k, shp in shapes.items():
            check(tuple(ob[k].shape) == (N_PAIRS, 1) + shp, f"batched {d} {k} shape")
            check(torch.isfinite(ob[k]).all().item(), f"batched {d} {k} not finite")
            # one pass over the batch reorders the CNN's sums; the wedge
            # cascade amplifies that at thresholds, so bound the bulk and the
            # flip share
            for i in range(N_PAIRS):
                dd = (ob[k][i] - outs[d][i][k]).abs().flatten()
                check(dd.kthvalue(int(0.8 * dd.numel())).values.item() < 1e-3,
                      f"batched {d} {k} p80")
                check((dd > 0.01).float().mean().item() < 0.05, f"batched {d} {k} flips")
        if d == "pp":
            # the U-Net's one pass over the batch is B single-pair passes
            for i in range(N_PAIRS):
                with torch.inference_mode():
                    alone = mods.unet_model(ob["global_depth"][i][:, None])[:, 0]
                err = (ob["depth_final"][i] - alone).abs().max().item()
                check(err < 1e-4 * max(1.0, alone.abs().max().item()),
                      f"batched pp: U-Net over the batch vs one pair: {err}")
    print("serving: shapes, finite maps and batched vs single agreement ok (densify "
          f"{', '.join(map(str, DENSIFY))})")

    # the estimators run their models in float32 whatever the caller set
    seen = []

    def record(mod, args):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))

    hooks = [m.register_forward_pre_hook(record)
             for m in (mods.local_model, mods.global_model, mods.unet_model)]
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        single[None](pairs[0])
        batched[None](np.stack(pairs[:2]))
        single["pp"](pairs[0])
        after = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        for h in hooks:
            h.remove()
    check(seen == [(False, False)] * 7, f"TF32 inside the estimators: {seen}")
    check(after == (True, True), f"the estimators did not restore TF32: {after}")
    print("serving: with TF32 left on by the caller, both estimators ran their models "
          "(the U-Net too, densify pp) with it off and restored it")

    # 4. the port on the card against the port on the CPU at a small size
    small = GridConfig(H=41, W=41)
    small_pair = make_pairs(np.random.default_rng(SEED + 2), 1, small.H)[0]
    mods_cpu = copy.deepcopy(mods)
    for m in (mods_cpu.local_model, mods_cpu.global_model, mods_cpu.unet_model):
        m.cpu()
    for d in DENSIFY:
        got = make_depth_estimator(mods, patch_cfg, small, cam, densify=d, device=dev)(small_pair)
        want = make_depth_estimator(mods_cpu, patch_cfg, small, cam, densify=d,
                                    device="cpu")(small_pair)
        for k in ("global_image", "global_shpd", "global_bndry"):
            g, w = got[k].cpu(), want[k]
            check(torch.allclose(g, w, rtol=5e-3, atol=5e-3), f"card vs CPU {d} {k}")
        for k in ("global_depth", "confidence") + (() if d == "pp" else ("depth_final",)):
            dd = (got[k].cpu() - want[k]).abs().flatten()
            q99 = dd.kthvalue(int(np.ceil(0.99 * dd.numel()))).values.item()
            check(q99 < 5e-3, f"card vs CPU {d} {k}: p99 {q99}")
        if d == "pp":
            # the U-Net spreads a knife-edge pixel of global_depth (allowed
            # above) over its receptive field, as in tests/test_torch_pipeline.py::
            # assert_pp_depth_close: fed the CPU's global depth, the card's
            # U-Net gives the CPU's depth_final to rtol 1e-4 (atol 1e-4 x
            # scale); end to end, p90 under 5e-3 and every pixel within 0.25 x scale
            w = want["depth_final"]
            scale = w.abs().max().item()
            with torch.inference_mode(), float32_precision():
                fed = mods.unet_model(want["global_depth"][:, None].to(dev))[:, 0].cpu()
            check(torch.allclose(fed, w, rtol=1e-4, atol=1e-4 * scale),
                  f"card vs CPU pp: U-Net on the same global depth, max|diff| "
                  f"{(fed - w).abs().max().item()}")
            dd = (got["depth_final"].cpu() - w).abs().flatten()
            q90 = dd.kthvalue(int(np.ceil(0.9 * dd.numel()))).values.item()
            check(q90 < 5e-3 and dd.max().item() < 0.25 * scale,
                  f"card vs CPU pp depth_final: p90 {q90}, max {dd.max().item()}")
    print(f"reference: card vs CPU port at 41x41 (densify {', '.join(map(str, DENSIFY))}) ok")

    # 4b. the block-tiled estimator at a small geometry (49x49 blocks over
    # 71x71, margins of 2 patches: 2x2 blocks), card against CPU, with the
    # 41x41 serving check's tolerances
    blk, bigs = GridConfig(H=49, W=49), GridConfig(H=71, W=71)
    small_big = make_pairs(np.random.default_rng(SEED + 4), 1, bigs.H)[0]
    got = pipe_big.make_big_depth_estimator(mods, patch_cfg, blk, bigs, cam, 2, block_chunk=3,
                                            device=dev)(small_big)
    want = pipe_big.make_big_depth_estimator(mods_cpu, patch_cfg, blk, bigs, cam, 2,
                                             block_chunk=3, device="cpu")(small_big)
    for k in ("global_image", "global_shpd", "global_bndry"):
        check(torch.allclose(got[k].cpu(), want[k], rtol=5e-3, atol=5e-3), f"big card vs CPU {k}")
    for k in ("global_depth", "confidence", "depth_final"):
        dd = (got[k].cpu() - want[k]).abs().flatten()
        q99 = dd.kthvalue(int(np.ceil(0.99 * dd.numel()))).values.item()
        check(q99 < 5e-3, f"big card vs CPU {k}: p99 {q99}")
    print("reference: the block-tiled estimator, card vs CPU port at 49x49 blocks over 71x71 ok")

    # 4c. bfloat16 networks (the float32 weights; the analytic chain float32)
    mods16 = copy.deepcopy(mods)
    for m in (mods16.local_model, mods16.global_model, mods16.unet_model):
        set_compute_dtype(m, torch.bfloat16)
    single16 = {d: make_depth_estimator(mods16, patch_cfg, grid, cam, densify=d,
                                        rho_prime=RHO_PRIME, device=dev) for d in DENSIFY}
    batched16 = {d: make_batched_depth_estimator(mods16, patch_cfg, grid, cam, densify=d,
                                                 rho_prime=RHO_PRIME, device=dev)
                 for d in DENSIFY}
    for d in DENSIFY:
        wedge_cuda.reset_launch_counts()
        with counting_epilogue(mods16.local_model, le_by_path, f"bf16_single_{d}", 0):
            res16 = [single16[d](p) for p in pairs]
        torch.cuda.synchronize()
        launches_by_path[f"bf16_single_{d}"] = wedge_cuda.launch_counts()
        wedge_cuda.reset_launch_counts()
        with counting_epilogue(mods16.local_model, le_by_path, f"bf16_batched_{d}", 0):
            res16_b = batched16[d](np.stack(pairs))
        torch.cuda.synchronize()
        launches_by_path[f"bf16_batched_{d}"] = wedge_cuda.launch_counts()
        check(launches_by_path[f"bf16_single_{d}"] == {"wedge_colors": N_PAIRS,
                                                       "wedge_render": N_PAIRS}
              and launches_by_path[f"bf16_batched_{d}"] == {"wedge_colors": 1, "wedge_render": 1},
              f"bf16 {d} launches")
        for out in res16 + [{k: v[0] for k, v in res16_b.items()}]:
            for k, shp in shapes.items():
                check(tuple(out[k].shape) == (1,) + shp and out[k].dtype == torch.float32,
                      f"bf16 {d} {k} shape/dtype")
                check(torch.isfinite(out[k]).all().item(), f"bf16 {d} {k} not finite")
    # the NN boundary: the bfloat16 estimator equals, bit for bit, the
    # float32 chain run on its networks' outputs cast to float32
    with torch.inference_mode():
        img = torch.from_numpy(pairs[0]).to(dev)
        patches = unfold(img, R, grid.stride)
        flat16 = patches.reshape(2 * L, R, R, 3)
        p16 = wrap_local_params(mods16.local_model(flat16).float())
        tok = normalize_token_features(p16, wedge_cuda.wedge_colors(p16, flat16, patch_cfg))
        src16 = tok.reshape(2, L, 19).permute(1, 0, 2).reshape(1, L, 38)
        den = denormalize_global_eval(mods16.global_model(src16).float()).reshape(1, Hp, Hp, 12)
        chain = fold_outputs(wedge_cuda.wedge_render(
            den[..., :8].contiguous(), params2etas(den[..., 8:]).contiguous(), patches[None],
            patch_cfg, dfd, RHO_PRIME, False), grid)
        chain["depth_final"] = torch.where(chain["confidence"] > 0.05, chain["global_depth"], 0.0)
    est16 = single16[None](pairs[0])
    for k in chain:
        check(torch.equal(est16[k], chain[k]), f"bf16 NN boundary: {k} differs from the "
              "float32 chain on the bf16 networks' outputs")
    print(f"serving bf16: single-pair and batched x{N_PAIRS} paths (densify "
          f"{', '.join(map(str, DENSIFY))}) ran, launches {N_PAIRS} and 1 of each kernel, maps "
          "float32 and finite; the estimator equals the float32 chain on its bf16 networks' "
          "outputs bit for bit ok")

    # 4d. the evaluation loops over a seeded test set: run_eval in each
    # densify mode (3 pairs) and run_eval_big (2 pairs), the estimator
    # wrapped to blank pair 1 (its call 2: call 0 is the warm-up)
    eval_logs = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        root = Path(tmp)
        write_test_set(root / "t147", make_pairs(np.random.default_rng(SEED + 5), 3, grid.H),
                       SEED + 6)
        write_test_set(root / "t587", make_pairs(np.random.default_rng(SEED + 7), 2, BIG),
                       SEED + 8)
        args = get_args("eval", argv=["--data_path", str(root / "t147")])
        for d in DENSIFY:
            args.densify = d
            wedge_cuda.reset_launch_counts()
            with blanking(pipe, "make_depth_estimator", 2), \
                    counting_epilogue(mods.local_model, le_by_path, f"run_eval_{d}", 10):
                res, log = run_loop(pipe.run_eval, args, mods, device=dev)
            launches_by_path[f"run_eval_{d}"] = wedge_cuda.launch_counts()
            check(launches_by_path[f"run_eval_{d}"] == {"wedge_colors": 4, "wedge_render": 4},
                  f"run_eval {d} launches {launches_by_path[f'run_eval_{d}']}")
            eval_logs[f"run_eval_{d}"] = (check_eval_log(f"run_eval {d}", res, log, 3, 1), res)
        args = get_args("eval", big=True, argv=["--data_path", str(root / "t587")])
        wedge_cuda.reset_launch_counts()
        with blanking(pipe_big, "make_big_depth_estimator", 2), \
                counting_epilogue(mods.local_model, le_by_path, "run_eval_big", 10):
            res, log = run_loop(pipe_big.run_eval_big, args, mods, device=dev)
        launches_by_path["run_eval_big"] = wedge_cuda.launch_counts()
        per_call = -(-N_BLOCKS // args.block_chunk)
        check(launches_by_path["run_eval_big"] == {"wedge_colors": 3 * per_call,
                                                   "wedge_render": 3 * per_call},
              f"run_eval_big launches {launches_by_path['run_eval_big']}")
        eval_logs["run_eval_big"] = (check_eval_log("run_eval_big", res, log, 2, 1), res)
    print("eval: " + "; ".join(
        f"{k} scored pairs {v[0]} (pair 1 blanked and excluded), "
        f"{v[1]['pairs_per_sec']:.3f} pairs/s" for k, v in eval_logs.items())
        + f"; launches {N_BLOCKS}/{BLOCK_CHUNK} a 587x587 call ok")

    # 5. training, the main path of the second slice: 3 epochs at full width
    # (147x147, 4,096 tokens, 8 layers, batch 8 in 4 chunks of 2), flash
    # attention, then a resumed call; the launches counted from 0 just
    # before each call
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        root = Path(tmp)
        (root / "data").mkdir()
        write_dataset(root / "data", N_TRAIN, N_VAL, grid, SEED + 11)
        calls, losses, curve = run_trainer(root)
        weights = root / "weights"
        check(checkpoint_exists(str(weights / "best_run_exp_global_stage")), "no best checkpoint")
        check(checkpoint_exists(str(weights / "last_exp_global_stage")), "no step snapshot")
        check((weights / "done_global").exists(), "no completion marker")
        train_data = tg.load_global_compact(str(root / "data"), train=True)
        val_data = tg.load_global_compact(str(root / "data"), train=False, include_ny=True)
    steps_per_epoch, val_batches = N_TRAIN // BATCH, N_VAL // BATCH
    check(len(losses) == 4 * steps_per_epoch and np.isfinite(losses).all(),
          f"train losses {losses}")
    check(curve.shape == (4,) and np.isfinite(curve).all(), f"val curve {curve}")
    check("RESUMED at epoch 3 step 0" in calls["resume"]["log"], "the second call did not resume")
    for name, epochs in (("train", 3), ("resume", 1)):
        want = {k: min(epochs * steps_per_epoch, PYTHON_STEPS) * STEP_LAUNCHES[k]
                + epochs * val_batches * VAL_BATCH_LAUNCHES[k] for k in STEP_LAUNCHES}
        check(calls[name]["flash"] == want,
              f"trainer ({name}) flash launches {calls[name]['flash']}, want {want}")
        check(not any(calls[name]["wedge"].values()), "the trainer launched a wedge kernel")
    launches_train = {k: calls["train"]["flash"][k] + calls["resume"]["flash"][k]
                      for k in STEP_LAUNCHES}
    print(f"train: 3 epochs x {steps_per_epoch} steps of batch {BATCH} (grad_accum {CHUNKS}) "
          f"at 147x147, flash attention, in {calls['train']['seconds']:.1f} s; resumed for one "
          f"epoch more in {calls['resume']['seconds']:.1f} s; losses {np.round(losses, 5).tolist()}, "
          f"val {np.round(curve, 5).tolist()}; checkpoint, snapshot and resume ok")
    print(f"train: flash launches from Python {launches_train} = per step {STEP_LAUNCHES} "
          f"(3 x chunks x layers forward: the forward, the chunk's recompute and the layer's "
          f"recompute) in each call's first {PYTHON_STEPS} steps (the rest replay a CUDA "
          f"graph) and per val batch {VAL_BATCH_LAUNCHES} ok")

    # 6. flash against matmul attention: one full-width step of each from the
    # same init (dropout 0), and the launches of one step and one val batch
    batch = tg.to_device_batch({k: v[:BATCH] for k, v in train_data.items()}, dev,
                               bf16_tokens=True)
    val_batch = tg.to_device_batch({k: v[:BATCH] for k, v in val_data.items()}, dev)
    results = {}
    for impl in ("xla", "flash"):
        fa.reset_launch_counts()
        results[impl] = one_step(fresh_model(impl, N_LAYERS, dev), batch, grid, patch_cfg,
                                 dfd, CHUNKS)
        torch.cuda.synchronize()
        counts = fa.launch_counts()
        want = STEP_LAUNCHES if impl == "flash" else dict.fromkeys(STEP_LAUNCHES, 0)
        check(counts == want, f"{impl} step: flash launches {counts}, want {want}")
    model = fresh_model("flash", N_LAYERS, dev)
    _, eval_step = tg.make_step_fns(model, make_optimizer(model.parameters(), LR), patch_cfg,
                                    grid, dfd, CHUNKS)
    fa.reset_launch_counts()
    val_loss = float(eval_step(val_batch, tg.gammas_to_array(GAMMAS, dev)))
    check(fa.launch_counts() == VAL_BATCH_LAUNCHES and math.isfinite(val_loss),
          f"val batch: launches {fa.launch_counts()}, loss {val_loss}")
    agree = compare_steps(results["flash"], results["xla"], "flash vs xla step")
    print(f"train: one full-width step, flash vs xla attention from the same init: "
          f"{ {k: float(f'{v:.3g}') for k, v in agree.items()} } ok; launches of one step "
          f"{STEP_LAUNCHES}, of one val batch {VAL_BATCH_LAUNCHES} ok")

    # 7. the port's step on the card against the port's step on the CPU at
    # 51x51 (256 tokens), two layers, 2 samples in 2 chunks
    small = GridConfig(H=51, W=51)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        write_dataset(Path(tmp), 2, 0, small, SEED + 12)
        small_np = tg.load_global_compact(tmp, train=True)
    steps = {}
    for where in ("cuda", "cpu"):
        d = dev if where == "cuda" else torch.device("cpu")
        steps[where] = one_step(fresh_model("flash", 2, d), tg.to_device_batch(small_np, d),
                                small, patch_cfg, dfd, 2)
    agree_cpu = compare_steps(steps["cuda"], steps["cpu"], "card vs CPU step")
    print(f"train: one step at 51x51, 2 layers, card (kernels) vs CPU (plain): "
          f"{ {k: float(f'{v:.3g}') for k, v in agree_cpu.items()} } ok")

    # 7b. the training-data path (the seventh slice): generate, train the
    # local stage, precal, train the global stage on those tokens, generate
    # test sets and evaluate them; each stage's launches counted from 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        gen_launches, gen_clock, gen_notes = run_datagen_path(Path(tmp), dev, grid, patch_cfg)
    wedge_names = ("wedge_colors", "wedge_render")
    for stage in ("global_precal", "run_eval_None", "run_eval_w", "run_eval_big"):
        launches_by_path[f"datagen_{stage}"] = {k: gen_launches[stage][k] for k in wedge_names}
    for stage in ("run_eval_coco_None", "run_eval_coco_w", "run_eval_big_coco"):
        launches_by_path[stage] = {k: gen_launches[stage][k] for k in wedge_names}
    par = gen_notes["parallel"]
    launches_by_path["densify_pipeline"] = {k: gen_launches["densify_pipeline"][k]
                                            for k in wedge_names}
    launches_by_path["eval_dp"] = {k: par["ws1"]["eval"][k] for k in wedge_names}
    launches_by_path["eval_big_dp"] = {k: par["ws1"]["eval_big"][k] for k in wedge_names}
    launches_train = {k: launches_train[k] + gen_launches["global_train"][k]
                      + par["ws1"]["global_train"][k] for k in STEP_LAUNCHES}
    errs["wedge_colors"] = max(errs["wedge_colors"],
                               gen_notes["precal_colors_vs_plain"]["max_abs"])
    print(f"datagen: gen_trainval {N_GEN_TRAIN}/{N_GEN_VAL} scenes (phases "
          f"{ {k: round(v, 2) for k, v in gen_notes['gen_phases'].items()} } s; shot-noise bias "
          f"{ {k: round(float(v), 2) for k, v in gen_notes['noise_z'].items()} } standard "
          f"errors), "
          f"local_train 2 epochs + 1 resumed (val {np.round(gen_notes['local_curve'], 5).tolist()}), "
          f"global_precal {N_GEN_TRAIN + N_GEN_VAL} pairs in batches of {PRECAL_BATCH} "
          f"({gen_launches['global_precal']['wedge_colors']} wedge_colors launches; card vs CPU "
          f"tokens of 4 pairs: {gen_notes['precal_vs_cpu']}; kernel vs plain on a device "
          f"batch: {gen_notes['precal_colors_vs_plain']}), global_train 1 epoch on those "
          f"tokens (val {np.round(gen_notes['global_val'], 5).tolist()}), gen_test "
          f"{N_GEN_TEST} + {N_GEN_TEST_BIG} big pairs (noise bias "
          f"{np.round(gen_notes['test_noise_z'], 2).tolist()}), evals "
          + "; ".join(f"{k} delta1 {v['delta1']:.4f} at {v['pairs_per_sec']:.3f} pairs/s"
                      for k, v in gen_notes["scores"].items()) + " ok")
    print(f"time datagen stages (s, peak device memory): {gen_clock.line()} [{card}]")
    coco = gen_notes["coco"]
    dec = coco["decode"]
    print("7c coco: nvJPEG decodes vs OpenCV (max, mean |diff|): "
          + "; ".join(f"{k} {v['max']}, {v['mean']}" for k, v in dec["jpeg"].items())
          + f"; PNGs bit for bit {dec['png']}; bounds {NVJPEG_MAX_ABS}, {NVJPEG_MEAN_ABS} ok")
    print(f"time 7c nvJPEG decode of one 640x480 JPEG, warm: "
          f"{dec['decode_640x480_ms']:.4f} ms with libjpeg's upsampling [{card}]")
    print(f"7c coco: gen_test --coco {N_COCO} pairs at 147x147 and --big --coco {N_COCO_BIG} at "
          f"{BIG}x{BIG} (nvJPEG decodes {coco['nvjpeg_decodes']}; noise bias "
          f"{coco['gen_test_coco_noise_z']:.2f}, {coco['gen_test_big_coco_noise_z']:.2f} standard "
          f"errors; mask pixels {coco['gen_test_coco_mask_px']}, "
          f"{coco['gen_test_big_coco_mask_px']}; clean counts up to "
          f"{coco['gen_test_coco_clean_max_over_alpha']:.4f}, "
          f"{coco['gen_test_big_coco_clean_max_over_alpha']:.4f} x alpha); masks, objects and "
          f"backgrounds card = CPU bit for bit; renders card vs CPU from the same key points at "
          f"{coco['render_card_vs_cpu_worst_over_tol']:.3f} of rtol 1e-4 atol 1e-3, from the "
          f"card's own key points max |diff| vs the ulp bound "
          f"{[(round(a, 4), round(b, 4)) for a, b in coco['render_card_key_points_max_vs_bound']]}"
          f"; evals "
          + "; ".join(f"{k} delta1 {v['delta1']:.4f}, launches "
                      f"{launches_by_path[k]}" for k, v in coco["scores"].items())
          + f"; the phase {coco['seconds']:.1f} s [{card}] ok")
    print(f"datagen launches by stage: {gen_launches}")
    det = gen_notes["determinism"]
    print("step 0, determinism: local_train 2 epochs twice each way: " + "; ".join(
        f"{mode}: bit-identical {det[mode]['bit_identical']}, max |diff| "
        f"{det[mode]['max_abs_diff']:.3g}, first differing {det[mode]['first_differing']}, "
        f"val curves {det[mode]['val_curves']}" for mode in ("deterministic", "default"))
        + f"; ops without a deterministic version: {det['ops_without_deterministic_version']} "
        f"[{card}]")
    f64 = gen_notes["cnn_float64"]
    print(f"step 0, float32 local CNN vs float64 on the card (TF32 off), the chain's trained "
          f"local stage over one precal batch: with cuDNN ({f64['cudnn']['patches']} patches) "
          f"p99 {f64['cudnn']['p99']:.3g}, max {f64['cudnn']['max']:.3g}; cuDNN off "
          f"({f64['no_cudnn']['patches']} patches) p99 {f64['no_cudnn']['p99']:.3g}, max "
          f"{f64['no_cudnn']['max']:.3g} [{card}]")
    den = gen_notes["densify"]
    pipe_s = gen_clock.rows["densify_pipeline"]
    print(f"densify: pipeline source {den['pipeline']['n_train']}/{den['pipeline']['n_val']} "
          f"maps ({N_REAL_TRAIN}/{N_REAL_VAL} realistic), sparse maps in "
          f"{den['pipeline']['sparse_seconds']:.2f} s, {DENSIFY_EPOCHS} epochs of "
          f"{den['pipeline']['steps'] // DENSIFY_EPOCHS} steps at "
          f"{np.round(den['pipeline']['epoch_seconds'], 3).tolist()} s, val "
          f"{np.round(den['pipeline']['curve'], 6).tolist()}, the path {pipe_s[0]:.2f} s at peak "
          f"{pipe_s[1]:.2f} GiB, launches {launches_by_path['densify_pipeline']}; simulated "
          f"source 1 epoch {np.round(den['simulated']['epoch_seconds'], 3).tolist()} s, val "
          f"{np.round(den['simulated']['curve'], 6).tolist()}; checkpoint served as densify pp; "
          f"first 4 sparse maps card vs CPU {den['sparse_vs_cpu']}; U-Net step at 41x41 card "
          f"vs CPU { {k: float(f'{v:.3g}') for k, v in den['unet_step_vs_cpu'].items()} } ok")
    print(f"time densify: sparse maps/s by chunk "
          f"{ {c: round(r, 3) for c, r in den['sparse_maps_per_s'].items()} } "
          f"({SWEEP_PAIRS} pairs), train step at batch 8, 147x147 {den['train_step_ms']:.2f} ms "
          f"(peak {den['train_step_peak_gib']:.2f} GiB) [{card}]")
    print(f"parallel: world size 1 under NCCL through local_train, global_train, eval and "
          f"eval_big ({par['ws1_seconds']:.1f} s with the rank's start), launches "
          f"{par['ws1']}; world size 2 under gloo on cuda:0 ({par['ws2_seconds']:.1f} s) vs one "
          f"process: {par['ws2_vs_one']} ok (no speed claimed: one card)")

    # 8. timings; the wedge kernels back to back (warm) and with the L2
    # cache flushed before each launch (cold: on the serving path the local
    # CNN runs between unfold and the kernels), at one pair and at x4
    with torch.inference_mode():
        w_ms = time_wedge(one, "single", patch_cfg, dfd)
        # the x4 inputs live only inside the call, out of the peaks measured below
        w_ms.update(time_wedge(path_inputs(mods, pairs, patch_cfg, grid, dev), f"x{N_PAIRS}",
                               patch_cfg, dfd))
        k_ms = {name: w_ms[name, "single", "warm"] for name in ("wedge_colors", "wedge_render")}
        p_ms = {
            "wedge_colors": cuda_ms(lambda: wedge_cuda.wedge_colors_plain(
                params, flat, patch_cfg), 10),
            "wedge_render": cuda_ms(lambda: wedge_cuda.wedge_render_plain(
                xy, etas, img_patches, patch_cfg, dfd, RHO_PRIME, False), 10)}
        # per-stage device time of one pair; the U-Net only for densify pp
        depth_in = outs["pp"][0]["global_depth"][:, None]
        stage_ms = {
            "local_cnn": cuda_ms(lambda: mods.local_model(flat), 5),
            "wedge_colors": k_ms["wedge_colors"],
            "global_stage": cuda_ms(lambda: mods.global_model(one["src"]), 5),
            "wedge_render": k_ms["wedge_render"],
            "fold": cuda_ms(lambda: fold_outputs(wedge_cuda.wedge_render(
                xy, etas, img_patches, patch_cfg, dfd, RHO_PRIME, False), grid), 10)
            - k_ms["wedge_render"],
            "unet": cuda_ms(lambda: mods.unet_model(depth_in), 10)}
    bytes_ = {"wedge_colors": 2 * L * ((10 + R * R * 3) + 9) * 4,
              "wedge_render": L * ((8 + 4 + 2 * R * R * 3) + R * R * 15) * 4}
    ops = {"wedge_colors": 2 * L * R * R * COLORS_OPS_PER_PIXEL,
           "wedge_render": L * R * R * RENDER_OPS_PER_PIXEL}
    for name in k_ms:
        bound = max(bytes_[name] / HBM_BYTES_PER_S, ops[name] / F32_OPS_PER_S) * 1e3
        cases = []
        for case, n in (("single pair", 1), (f"x{N_PAIRS}", N_PAIRS)):
            key = "single" if n == 1 else f"x{N_PAIRS}"
            warm, cold = w_ms[name, key, "warm"], w_ms[name, key, "cold"]
            cases.append(f"{case}: warm {warm:.4f} ms ({n * bound / warm:.1%} of its bound "
                         f"{n * bound:.4f}), cold {cold:.4f} ms ({n * bound / cold:.1%})")
        print(f"time {name}: " + "; ".join(cases) + f"; plain {p_ms[name]:.4f} ms (single "
              f"pair) [{card}]")
        print(f"time {name} at the 587x587 path's chunks (warm): " + "; ".join(
            f"{c} blocks {big_ms[name, c]:.4f} ms ({c * bound / big_ms[name, c]:.1%} of its "
            f"bound {c * bound:.4f})" for c in BIG_CHUNKS) + f" [{card}]")
    print(f"time stages of one pair (ms): "
          + ", ".join(f"{k} {v:.3f}" for k, v in stage_ms.items()) + f" [{card}]")
    with torch.inference_mode():
        src = one["src"]
        gm = mods.global_model
        n_layers = len(gm.encoder.layers)
        d_model = gm.in_src_projection.out_features
        # the hooks see the nn.Linear layers; add each layer's packed q/k/v
        # projection (a functional linear) and its q.k^T and probs.v
        per_layer = 2 * L * d_model * 3 * d_model + 4 * L * L * d_model
        # the CNN on the meta device, where its layers run as modules: on
        # the card its convolutions run inside ops.local_epilogue, unhooked
        flops = {"local_cnn": matmul_flops(copy.deepcopy(mods.local_model).to("meta"),
                                           flat.to("meta")),
                 "global_stage": matmul_flops(gm, src) + per_layer * n_layers,
                 "unet": matmul_flops(mods.unet_model, depth_in)}
    print("rate of the models' matmuls and convolutions: " + ", ".join(
        f"{k} {f / 1e12:.4f} TFLOP in {stage_ms[k]:.3f} ms = "
        f"{f / stage_ms[k] / 1e9:.2f} TFLOP/s ({f / stage_ms[k] / 1e9 / (F32_OPS_PER_S / 1e12):.1%} "
        f"of the float32 peak)" for k, f in flops.items()) + f" [{card}]")

    def pairs_per_s(fn, arg, n_pairs, iters):
        fn(arg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(arg)
        torch.cuda.synchronize()
        return iters * n_pairs / (time.perf_counter() - t0)

    def rate_and_peak(fn, arg, n_pairs, iters):
        torch.cuda.reset_peak_memory_stats()
        rate = pairs_per_s(fn, arg, n_pairs, iters)
        return rate, torch.cuda.max_memory_allocated() / 2**30

    stacked = np.stack(pairs)
    for d in DENSIFY:
        single_rate, single_peak = rate_and_peak(single[d], pairs[0], 1, 20)
        batched_rate, batched_peak = rate_and_peak(batched[d], stacked, N_PAIRS, 5)
        busy = sum(v for k, v in stage_ms.items() if d == "pp" or k != "unet") * single_rate / 1e3
        print(f"time serving (densify {d}): single pair {single_rate:.3f} pairs/s (peak "
              f"{single_peak:.2f} GiB, device busy ~{busy:.2f} of the wall time by the stage "
              f"sum), batched x{N_PAIRS} {batched_rate:.3f} pairs/s (peak {batched_peak:.2f} "
              f"GiB) [{card}]")

    # the same with the three networks in bfloat16
    with torch.inference_mode():
        stage16 = {"local_cnn": cuda_ms(lambda: mods16.local_model(flat), 5),
                   "global_stage": cuda_ms(lambda: mods16.global_model(one["src"]), 5),
                   "unet": cuda_ms(lambda: mods16.unet_model(depth_in), 10)}
    print("time stages of one pair, networks in bfloat16 (ms): " + ", ".join(
        f"{k} {v:.3f} (float32 {stage_ms[k]:.3f}, {f_ / v / 1e9:.1f} TFLOP/s)"
        for (k, v), f_ in zip(stage16.items(), (flops[k] for k in stage16))) + f" [{card}]")
    for d in DENSIFY:
        single_rate, single_peak = rate_and_peak(single16[d], pairs[0], 1, 20)
        batched_rate, batched_peak = rate_and_peak(batched16[d], stacked, N_PAIRS, 5)
        print(f"time serving bf16 (densify {d}): single pair {single_rate:.3f} pairs/s (peak "
              f"{single_peak:.2f} GiB), batched x{N_PAIRS} {batched_rate:.3f} pairs/s (peak "
              f"{batched_peak:.2f} GiB) [{card}]")

    # one 587x587 pair at full width, at the default chunk and one other
    pair587 = make_pairs(np.random.default_rng(SEED + 9), 1, BIG)[0]
    big_grid = GridConfig(H=BIG, W=BIG)
    big_out = {}
    for c in (BLOCK_CHUNK, OTHER_CHUNK):
        est = pipe_big.make_big_depth_estimator(mods, patch_cfg, grid, big_grid, cam, N_MARGIN,
                                                rho_prime=RHO_PRIME, block_chunk=c, device=dev)
        est(pair587)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        wedge_cuda.reset_launch_counts()
        t0 = time.perf_counter()
        with counting_epilogue(mods.local_model, le_by_path, f"big_587_chunk{c}", 10):
            big_out[c] = est(pair587)
        secs = time.perf_counter() - t0
        launches_by_path[f"big_587_chunk{c}"] = wedge_cuda.launch_counts()
        want_n = -(-N_BLOCKS // c)
        check(launches_by_path[f"big_587_chunk{c}"] == {"wedge_colors": want_n,
                                                        "wedge_render": want_n},
              f"587x587 chunk {c}: launches {launches_by_path[f'big_587_chunk{c}']}")
        for k, shp in dict(global_image=(2, BIG, BIG, 3), confidence=(BIG, BIG),
                           depth_final=(BIG, BIG)).items():
            check(tuple(big_out[c][k].shape) == (1,) + shp
                  and torch.isfinite(big_out[c][k]).all().item(), f"587x587 {k}")
        check((big_out[c]["depth_final"] > 0).any().item(), "587x587: no depth predicted")
        print(f"time 587x587 pair, float32, block_chunk {c}: {secs:.3f} s, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
              f"{launches_by_path[f'big_587_chunk{c}']}, local_epilogue "
              f"{le_by_path[f'big_587_chunk{c}']} [{card}]")
        del est
    for k in big_out[BLOCK_CHUNK]:
        dd = (big_out[BLOCK_CHUNK][k] - big_out[OTHER_CHUNK][k]).abs().flatten()
        check(dd.kthvalue(int(0.8 * dd.numel())).values.item() < 1e-3
              and (dd > 0.01).float().mean().item() < 0.05, f"587x587 chunk {BLOCK_CHUNK} vs "
              f"{OTHER_CHUNK}: {k}")
    del big_out
    torch.cuda.empty_cache()
    print(f"587x587: the two chunks' maps agree (bulk and flip share as batched vs single) ok")

    # the flash kernels at a training chunk's shape, and the training step
    f_ms, f_plain, f_lib = time_flash(dev)
    f_bound = flash_bounds(FLASH_SHAPE)
    for name in FLASH_OPS_PER_PAIR_D:
        fp32, tc = f_bound[name]["fp32"][0], f_bound[name]["tensor_core"][0]
        print(f"time {name} {FLASH_SHAPE}: kernel {f_ms[name]:.4f} ms, bound fp32 {fp32:.4f} "
              f"ms ({fp32 / f_ms[name]:.1%} of it reached), bound tensor-core {tc:.4f} ms "
              f"({tc / f_ms[name]:.1%}), plain {f_plain[name]:.4f} ms, "
              f"scaled_dot_product_attention {f_lib[name]:.4f} ms [{card}]")
    step_ms, step_peak = {}, {}
    gammas = tg.gammas_to_array(GAMMAS, dev)
    for impl in ("flash", "xla"):
        model = GlobalStage(attn_impl=impl)      # the trainer's model: dropout 0.1
        xavier_reinit(model, torch.Generator().manual_seed(1898))
        model.to(dev)
        step, _ = tg.make_step_fns(model, make_optimizer(model.parameters(), LR), patch_cfg,
                                   grid, dfd, CHUNKS)
        step(batch, gammas, 0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for i in range(3):
            step(batch, gammas, i + 1)
        torch.cuda.synchronize()
        step_ms[impl] = (time.perf_counter() - t0) / 3 * 1e3
        step_peak[impl] = torch.cuda.max_memory_allocated() / 2**30
        del model, step
    print("time train step at full width, batch 8: " + ", ".join(
        f"{impl} {step_ms[impl]:.1f} ms (peak {step_peak[impl]:.2f} GiB)" for impl in step_ms)
        + f" [{card}]")
    print(profile_step(batch, gammas, grid, patch_cfg, dfd, dev) + f" [{card}]")

    # every path's launches, each path's counted from 0 just before it
    launches = {k: sum(c[k] for c in launches_by_path.values()) for k in wedge_cuda.launch_counts()}
    kernels = []
    for name, src, tpu in (
            ("wedge_colors", "blurry_edges_tpu_torch/csrc/wedge_colors.cu",
             "blurry_edges_tpu/ops/wedge_pallas.py:151"),
            ("wedge_render", "blurry_edges_tpu_torch/csrc/wedge_render.cu",
             "blurry_edges_tpu/ops/wedge_pallas.py:337")):
        t_bytes = bytes_[name] / HBM_BYTES_PER_S * 1e3
        t_ops = ops[name] / F32_OPS_PER_S * 1e3
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=tpu,
            launches=launches[name],
            launches_by_path={path: c[name] for path, c in launches_by_path.items()},
            max_abs_err=errs[name], ms=k_ms[name],
            ms_by_case={**{f"{case}_{temp}": w_ms[name, case, temp]
                           for case in ("single", f"x{N_PAIRS}") for temp in ("warm", "cold")},
                        **{f"big_chunk{c}_warm": big_ms[name, c] for c in BIG_CHUNKS}},
            bound_ms_by_case={f"big_chunk{c}": c * max(t_bytes, t_ops) for c in BIG_CHUNKS},
            plain_ms=p_ms[name], bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None))
    flash_src = {"flash_fwd": ("blurry_edges_tpu_torch/csrc/flash_attn_fwd.cu", "flash_attention.py:589"),
                 "flash_bwd_dkv": ("blurry_edges_tpu_torch/csrc/flash_attn_bwd_dkv.cu", "flash_attention.py:941"),
                 "flash_bwd_dq": ("blurry_edges_tpu_torch/csrc/flash_attn_bwd_dq.cu", "flash_attention.py:1287")}
    for name, (src, lib_line) in flash_src.items():
        # bound_ms: the least of the two bounds, the tensor cores' (3xTF32)
        bound, bound_by = f_bound[name]["tensor_core"]
        kernels.append(dict(
            name=name, route="cuda", source=src,
            replaces=f"jax/experimental/pallas/ops/tpu/{lib_line}",
            reached_by="blurry_edges_tpu/models/global_stage.py:21",
            launches=launches_train[name],
            launches_by_path={"train": calls["train"]["flash"][name],
                              "resume": calls["resume"]["flash"][name],
                              "datagen_global_train": gen_launches["global_train"][name],
                              "global_train_dp": par["ws1"]["global_train"][name]},
            max_abs_err=errs[name], ms=f_ms[name], plain_ms=f_plain[name],
            bound_ms=bound, bound_by=bound_by, bound_fp32_ms=f_bound[name]["fp32"][0],
            library_ms=f_lib[name]))
    # the LocalStage's tail: bound by the bytes of its ten junctions at 8,192 patches
    le_bound = {name: 8192 * epilogue_floats(name) * 4 / HBM_BYTES_PER_S * 1e3
                for name in JUNCTIONS}
    le_ms, le_plain = sum(ep["ms"].values()), sum(ep["plain_ms"].values())
    print("time local_epilogue at 8,192 patches by junction (ms): " + ", ".join(
        f"{name} {ep['ms'][name]:.4f} ({le_bound[name] / ep['ms'][name]:.1%} of its bound "
        f"{le_bound[name]:.4f}; plain {ep['plain_ms'][name]:.4f})" for name in JUNCTIONS)
        + f"; the ten {le_ms:.4f} ms against a bound of {sum(le_bound.values()):.4f} "
        f"({sum(le_bound.values()) / le_ms:.1%}), plain {le_plain:.4f} (without the bias adds "
        f"{sum(ep['plain_nobias_ms'].values()):.4f}); by TILE_FLOATS (chosen {le.TILE_FLOATS}): "
        + ", ".join(f"{t} {v:.4f}" for t, v in ep["by_tile"].items()) + f" [{card}]")
    kernels.append(dict(
        name="local_epilogue", route="cuda", source="blurry_edges_tpu_torch/csrc/local_epilogue.cu",
        replaces=None, reached_by="blurry_edges_tpu_torch/models/local_stage.py::tail",
        launches=sum(c["launches"] for c in le_by_path.values()),
        launches_by_path={path: c["launches"] for path, c in le_by_path.items()},
        forwards_by_path={path: c["forwards"] for path, c in le_by_path.items()},
        max_ulps=ep["errs"], ms=le_ms, ms_by_case=ep["ms"],
        ms_by_tile_floats=ep["by_tile"], plain_ms=le_plain,
        plain_without_bias_ms=sum(ep["plain_nobias_ms"].values()),
        bound_ms=sum(le_bound.values()), bound_ms_by_case=le_bound, bound_by="bytes",
        library_ms=None))
    print(f"total: {time.perf_counter() - t_start:.1f} s after start-up, "
          f"build {lib.build_seconds:.2f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as e:
        print(f"chip_smoke: check failed: {e}", file=sys.stderr)
        sys.exit(1)
