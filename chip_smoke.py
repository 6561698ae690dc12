#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

From the repository root, on a machine with one CUDA card and the CUDA
toolkit (``nvcc``). It builds the five kernels from ``csrc/`` (the two wedge
kernels and flash attention's forward, dK/dV and dQ), prints ptxas's
registers, shared memory and spills of the three tensor-core flash kernels
and of both wedge kernels, fails if a flash kernel's SASS holds no
tensor-core instruction, holds each kernel against its plain PyTorch
version at the shapes of the path that runs it and on degenerate or ragged
inputs, and drives both slices of the port with seeded random full-width
weights: it serves a few 147x147 pairs through the estimators (densify
none, w and pp, the last through the depth-completion U-Net), and trains
the global stage at full width (147x147, 4,096 tokens, 8 layers, batch 8)
for three epochs on a seeded synthetic dataset in a temporary directory,
then resumes it. It checks the outputs (shapes,
finite values, the launch counts of each path, flash against matmul
attention, the card against the CPU at a small size), times the kernels
(the wedge kernels also with the L2 cache flushed before each launch, as
the serving path finds their inputs after the local CNN), the serving
paths and the training step, and prints as its last line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before
that line. Without a CUDA device it exits non-zero at once.

TF32 is off for matmuls and convolutions, so the card computes in float32
as the CPU reference does.
"""

from __future__ import annotations

import argparse
import copy
import io
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from blurry_edges_tpu_torch.config import (  # noqa: E402
    CamConfig, GridConfig, PatchConfig, get_args)
from blurry_edges_tpu_torch.eval.pipeline import (  # noqa: E402
    fold_outputs, make_batched_depth_estimator, make_depth_estimator)
from blurry_edges_tpu_torch.models.global_stage import GlobalStage  # noqa: E402
from blurry_edges_tpu_torch.ops import flash_attention as fa  # noqa: E402
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
from blurry_edges_tpu_torch.utils.weights import random_modules  # noqa: E402

SEED = 0
N_PAIRS = 4
DENSIFY = (None, "w", "pp")        # the serving paths, single pair and batched
RHO_PRIME = 10.39
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("setup: TF32 off for matmuls and cuDNN convolutions (float32 throughout)")
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}")
    t_start = time.perf_counter()

    # 1. build: every source by its own nvcc, all started together
    lib = load_library()
    regs = [ln.strip() for ln in lib.log.splitlines() if "registers" in ln]
    print(f"build: {lib.build_seconds:.2f} s for the five kernels of "
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
    outs, out_b, launches_by_path = {}, {}, {}
    for d, fn in single.items():
        wedge_cuda.reset_launch_counts()
        outs[d] = [fn(p) for p in pairs]
        torch.cuda.synchronize()
        launches_by_path[f"single_{d}"] = wedge_cuda.launch_counts()
    for d, fn in batched.items():
        wedge_cuda.reset_launch_counts()
        out_b[d] = fn(np.stack(pairs))
        torch.cuda.synchronize()
        launches_by_path[f"batched_{d}"] = wedge_cuda.launch_counts()
    print(f"serving: single-pair paths, {N_PAIRS} calls each, and batched paths, 1 call of "
          f"{N_PAIRS} pairs each (densify {', '.join(map(str, DENSIFY))}): launches "
          f"{launches_by_path}")
    # once a call: a single-pair call is one pair, the batched call's one
    # launch covers its 4 pairs; the pp paths as the others
    for path, got in launches_by_path.items():
        n = N_PAIRS if path.startswith("single") else 1
        check(got == {"wedge_colors": n, "wedge_render": n},
              f"{path} launches {got}, want {n} of each")
    launches = {k: sum(c[k] for c in launches_by_path.values()) for k in wedge_cuda.launch_counts()}
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
        want = {k: epochs * (steps_per_epoch * STEP_LAUNCHES[k]
                             + val_batches * VAL_BATCH_LAUNCHES[k]) for k in STEP_LAUNCHES}
        check(calls[name]["flash"] == want,
              f"trainer ({name}) flash launches {calls[name]['flash']}, want {want}")
        check(not any(calls[name]["wedge"].values()), "the trainer launched a wedge kernel")
    launches_train = {k: calls["train"]["flash"][k] + calls["resume"]["flash"][k]
                      for k in STEP_LAUNCHES}
    print(f"train: 3 epochs x {steps_per_epoch} steps of batch {BATCH} (grad_accum {CHUNKS}) "
          f"at 147x147, flash attention, in {calls['train']['seconds']:.1f} s; resumed for one "
          f"epoch more in {calls['resume']['seconds']:.1f} s; losses {np.round(losses, 5).tolist()}, "
          f"val {np.round(curve, 5).tolist()}; checkpoint, snapshot and resume ok")
    print(f"train: flash launches {launches_train} = per step {STEP_LAUNCHES} and per val "
          f"batch {VAL_BATCH_LAUNCHES} (3 x chunks x layers forward: the forward, the chunk's "
          f"recompute and the layer's recompute) ok")

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
        flops = {"local_cnn": matmul_flops(mods.local_model, flat),
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
            ms_by_case={f"{case}_{temp}": w_ms[name, case, temp]
                        for case in ("single", f"x{N_PAIRS}") for temp in ("warm", "cold")},
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
                              "resume": calls["resume"]["flash"][name]},
            max_abs_err=errs[name], ms=f_ms[name], plain_ms=f_plain[name],
            bound_ms=bound, bound_by=bound_by, bound_fp32_ms=f_bound[name]["fp32"][0],
            library_ms=f_lib[name]))
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
