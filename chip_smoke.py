#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

From the repository root, on a machine with one CUDA card and the CUDA
toolkit (``nvcc``). It builds the wedge kernels from ``csrc/``, holds each
kernel against its plain PyTorch version at the serving shapes and on
degenerate inputs, serves a few 147x147 pairs through the port's estimators
with seeded random full-width weights, checks the outputs (shapes, finite
values, agreement with the port on the CPU at a small size), times the
kernels and the pipeline, and prints as its last line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before that
line. Without a CUDA device it exits non-zero at once.

TF32 is off for matmuls and convolutions, so the card computes in float32
as the CPU reference does.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from blurry_edges_tpu_torch.config import CamConfig, GridConfig, PatchConfig  # noqa: E402
from blurry_edges_tpu_torch.eval.pipeline import (  # noqa: E402
    fold_outputs, make_batched_depth_estimator, make_depth_estimator)
from blurry_edges_tpu_torch.ops import wedge_cuda  # noqa: E402
from blurry_edges_tpu_torch.ops._build import load_library  # noqa: E402
from blurry_edges_tpu_torch.ops.dfd import DfDSolver  # noqa: E402
from blurry_edges_tpu_torch.ops.params import (  # noqa: E402
    denormalize_global_eval, normalize_token_features, wrap_local_params)
from blurry_edges_tpu_torch.ops.patchify import unfold  # noqa: E402
from blurry_edges_tpu_torch.ops.wedge import params2etas  # noqa: E402
from blurry_edges_tpu_torch.utils.weights import random_modules  # noqa: E402

SEED = 0
N_PAIRS = 4
RHO_PRIME = 10.39
# H100 SXM peaks (NVIDIA data sheet): HBM rate and float32 outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# float32 operations a pixel that each kernel's function needs (a
# multiply-add counts 2): the counts in the notes at the head of
# csrc/wedge_colors.cu and csrc/wedge_render.cu, which break them down
COLORS_OPS_PER_PIXEL = 150
RENDER_OPS_PER_PIXEL = 420


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


def matmul_flops(model, x) -> int:
    """Multiply-add FLOPs (2 a multiply-add) of the convolutions and linear
    layers of one forward of ``model`` on ``x``, counted by forward hooks."""
    total = 0

    def hook(mod, inputs, out):
        nonlocal total
        if isinstance(mod, torch.nn.Conv2d):
            k = mod.kernel_size[0] * mod.kernel_size[1]
            total += 2 * out.numel() * mod.in_channels * k // mod.groups
        else:
            total += 2 * out.numel() * mod.in_features

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
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

    # 1. build
    lib = load_library()
    regs = [ln.strip() for ln in lib.log.splitlines() if "registers" in ln]
    print(f"build: {lib.build_seconds:.2f} s -> {lib.path.name}; ptxas: {regs}")

    # 2. each kernel against its plain version at the main path's shapes
    patch_cfg, cam, grid = PatchConfig(), CamConfig(), GridConfig()
    dfd = DfDSolver.from_config(cam, patch_cfg)
    R, Hp, L = grid.R, grid.H_patches, grid.num_tokens
    gen = torch.Generator().manual_seed(SEED)
    mods = random_modules(gen, dev)
    rng = np.random.default_rng(SEED)
    pairs = make_pairs(rng, N_PAIRS, grid.H)

    with torch.inference_mode():
        one = path_inputs(mods, pairs[:1], patch_cfg, grid, dev)    # 8,192 / 4,096 patches
        four = path_inputs(mods, pairs, patch_cfg, grid, dev)       # 32,768 / 16,384 patches
        params, flat, xy, etas = one["params"], one["flat"], one["xy"], one["etas"]
        img_patches = one["img_patches"]

        def random_geometry(B, seed):
            g = torch.Generator().manual_seed(seed)
            xy_ = torch.cat([torch.rand((B, Hp, Hp, 4), generator=g) * 1.6 - 0.8,
                             torch.rand((B, Hp, Hp, 4), generator=g) * 2 * np.pi], -1)
            return xy_.to(dev), params2etas(torch.randn((B, Hp, Hp, 4), generator=g)).to(dev)

        zero_params = torch.zeros_like(params)
        zero_params[:, 8:] = 2.0

        errs = {"wedge_colors": 0.0, "wedge_render": 0.0}
        colors_cases = (("single-pair path", params, flat),
                        (f"batched path x{N_PAIRS}", four["params"], four["flat"]),
                        ("degenerate", zero_params, flat))
        for case, p, f in colors_cases:
            e = compare_colors(wedge_cuda.wedge_colors(p, f, patch_cfg),
                               wedge_cuda.wedge_colors_plain(p, f, patch_cfg))
            errs["wedge_colors"] = max(errs["wedge_colors"], e)
            print(f"kernel wedge_colors vs plain [{case}, P={p.shape[0]}]: max|diff| {e:.3g} ok")
        render_cases = (
            ("single-pair path", xy, etas, img_patches),
            (f"batched path x{N_PAIRS}", four["xy"], four["etas"], four["img_patches"]),
            ("random geometry", *random_geometry(1, SEED + 1), img_patches),
            (f"random geometry x{N_PAIRS}", *random_geometry(N_PAIRS, SEED + 3),
             four["img_patches"]),
            ("degenerate", torch.zeros_like(xy), torch.full_like(etas, 0.01), img_patches))
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

    # 3. serving: each path's launches counted from 0 just before it
    single = {d: make_depth_estimator(mods, patch_cfg, grid, cam, densify=d,
                                      rho_prime=RHO_PRIME, device=dev)
              for d in (None, "w")}
    batched = make_batched_depth_estimator(mods, patch_cfg, grid, cam,
                                           rho_prime=RHO_PRIME, device=dev)
    H = grid.H
    shapes = dict(global_image=(2, H, H, 3), global_shpd=(H, H, 3), global_refoc=(H, H, 3),
                  global_bndry=(H, H), global_depth=(H, H), confidence=(H, H),
                  depth_final=(H, H))
    wedge_cuda.reset_launch_counts()
    outs = {d: [fn(p) for p in pairs] for d, fn in single.items()}
    torch.cuda.synchronize()
    launches_single = wedge_cuda.launch_counts()
    wedge_cuda.reset_launch_counts()
    out_b = batched(np.stack(pairs))
    torch.cuda.synchronize()
    launches_batched = wedge_cuda.launch_counts()
    n_single = len(single) * N_PAIRS
    print(f"serving: single-pair path, {n_single} calls (densify none, w): "
          f"launches {launches_single}")
    print(f"serving: batched path, 1 call of {N_PAIRS} pairs: launches {launches_batched}")
    # once a call: a single-pair call is one pair, the batched call's one
    # launch covers its 4 pairs
    check(launches_single == {"wedge_colors": n_single, "wedge_render": n_single},
          f"single-pair path launches {launches_single}, want {n_single} of each")
    check(launches_batched == {"wedge_colors": 1, "wedge_render": 1},
          f"batched path launches {launches_batched}, want 1 of each")
    launches = {k: launches_single[k] + launches_batched[k] for k in launches_single}
    for d, res in outs.items():
        for out in res:
            for k, shp in shapes.items():
                check(tuple(out[k].shape) == (1,) + shp, f"{k} shape {tuple(out[k].shape)}")
                check(torch.isfinite(out[k]).all().item(), f"densify {d}: {k} not finite")
            check((out["depth_final"] > 0).any().item(), f"densify {d}: no depth predicted")
    for k, shp in shapes.items():
        check(tuple(out_b[k].shape) == (N_PAIRS, 1) + shp, f"batched {k} shape")
        check(torch.isfinite(out_b[k]).all().item(), f"batched {k} not finite")
        # one pass over the batch reorders the CNN's sums; the wedge cascade
        # amplifies that at thresholds, so bound the bulk and the flip share
        for i in range(N_PAIRS):
            d = (out_b[k][i] - outs[None][i][k]).abs().flatten()
            check(d.kthvalue(int(0.8 * d.numel())).values.item() < 1e-3, f"batched {k} p80")
            check((d > 0.01).float().mean().item() < 0.05, f"batched {k} flips")
    print("serving: shapes, finite maps and batched vs single agreement ok")

    # the estimators run their models in float32 whatever the caller set
    seen = []

    def record(mod, args):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))

    hooks = [m.register_forward_pre_hook(record) for m in (mods.local_model, mods.global_model)]
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        single[None](pairs[0])
        batched(np.stack(pairs[:2]))
        after = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        for h in hooks:
            h.remove()
    check(seen == [(False, False)] * 4, f"TF32 inside the estimators: {seen}")
    check(after == (True, True), f"the estimators did not restore TF32: {after}")
    print("serving: with TF32 left on by the caller, both estimators ran their models "
          "with it off and restored it")

    # 4. the port on the card against the port on the CPU at a small size
    small = GridConfig(H=41, W=41)
    small_pair = make_pairs(np.random.default_rng(SEED + 2), 1, small.H)[0]
    mods_cpu = copy.deepcopy(mods)
    mods_cpu.local_model.cpu()
    mods_cpu.global_model.cpu()
    for d in (None, "w"):
        got = make_depth_estimator(mods, patch_cfg, small, cam, densify=d, device=dev)(small_pair)
        want = make_depth_estimator(mods_cpu, patch_cfg, small, cam, densify=d,
                                    device="cpu")(small_pair)
        for k in ("global_image", "global_shpd", "global_bndry"):
            g, w = got[k].cpu(), want[k]
            check(torch.allclose(g, w, rtol=5e-3, atol=5e-3), f"card vs CPU {d} {k}")
        for k in ("global_depth", "confidence", "depth_final"):
            dd = (got[k].cpu() - want[k]).abs().flatten()
            q99 = dd.kthvalue(int(np.ceil(0.99 * dd.numel()))).values.item()
            check(q99 < 5e-3, f"card vs CPU {d} {k}: p99 {q99}")
    print("reference: card vs CPU port at 41x41 (densify none, w) ok")

    # 5. timings
    with torch.inference_mode():
        k_ms = {
            "wedge_colors": cuda_ms(lambda: wedge_cuda.wedge_colors(params, flat, patch_cfg), 50),
            "wedge_render": cuda_ms(lambda: wedge_cuda.wedge_render(
                xy, etas, img_patches, patch_cfg, dfd, RHO_PRIME, False), 50)}
        p_ms = {
            "wedge_colors": cuda_ms(lambda: wedge_cuda.wedge_colors_plain(
                params, flat, patch_cfg), 10),
            "wedge_render": cuda_ms(lambda: wedge_cuda.wedge_render_plain(
                xy, etas, img_patches, patch_cfg, dfd, RHO_PRIME, False), 10)}
        # per-stage device time of one pair
        stage_ms = {
            "local_cnn": cuda_ms(lambda: mods.local_model(flat), 5),
            "wedge_colors": k_ms["wedge_colors"],
            "global_stage": cuda_ms(lambda: mods.global_model(one["src"]), 5),
            "wedge_render": k_ms["wedge_render"],
            "fold": cuda_ms(lambda: fold_outputs(wedge_cuda.wedge_render(
                xy, etas, img_patches, patch_cfg, dfd, RHO_PRIME, False), grid), 10)
            - k_ms["wedge_render"]}
    bytes_ = {"wedge_colors": 2 * L * ((10 + R * R * 3) + 9) * 4,
              "wedge_render": L * ((8 + 4 + 2 * R * R * 3) + R * R * 15) * 4}
    ops = {"wedge_colors": 2 * L * R * R * COLORS_OPS_PER_PIXEL,
           "wedge_render": L * R * R * RENDER_OPS_PER_PIXEL}
    for name in k_ms:
        print(f"time {name}: kernel {k_ms[name]:.4f} ms, plain {p_ms[name]:.4f} ms "
              f"[{card}]")
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
                 "global_stage": matmul_flops(gm, src) + per_layer * n_layers}
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

    torch.cuda.reset_peak_memory_stats()
    single_rate = pairs_per_s(single[None], pairs[0], 1, 20)
    single_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    stacked = np.stack(pairs)
    batched_rate = pairs_per_s(batched, stacked, N_PAIRS, 5)
    batched_peak = torch.cuda.max_memory_allocated() / 2**30
    busy = sum(stage_ms.values()) * single_rate / 1e3
    print(f"time serving: single pair {single_rate:.3f} pairs/s (peak {single_peak:.2f} GiB, "
          f"device busy ~{busy:.2f} of the wall time by the stage sum), "
          f"batched x{N_PAIRS} {batched_rate:.3f} pairs/s (peak {batched_peak:.2f} GiB) "
          f"[{card}]")

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
            launches_by_path={"single": launches_single[name],
                              "batched": launches_batched[name]},
            max_abs_err=errs[name], ms=k_ms[name],
            plain_ms=p_ms[name], bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
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
