#!/usr/bin/env python3
"""Trace the entries of the committed-weight 587x587 comparison
(tests/test_torch_big.py::test_committed_weights_587_pair) that lie outside
the 147x147 slice's rtol/atol 5e-3 back to their blocks and patches, on
the CPU. Each step is a process of its own (torch's and XLA-CPU's thread
pools can deadlock in one):

    JAX_PLATFORMS=cpu python trace_587_pair.py jax  --out DIR   # ~10 min
    python trace_587_pair.py port --out DIR                     # ~15 min
    python trace_587_pair.py analyze --out DIR                  # ~3 min

``jax`` and ``port`` run the test's pair (tests/test_torch_big.py::
smooth_pair(587, 3)) through each package's 147x147 core, block by block
(36 blocks), with the committed local stage and the big path's own global
stage, and save each block's local parameters, tokens, global output and
render (sharpened patches, boundary maps) to ``.npy`` files in DIR.
``analyze`` stitches and folds both sides' renders as the big path does,
lists the out-of-tolerance entries' worst covering patch and what differs
there (parameters, tokens, global output), counts the angle wraps, feeds
JAX's tokens to the port's global stage and JAX's global output to the
port's render in the blocks concerned, and runs the local CNN in float64 on
two of them to see which float32 CNN is further from it.
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

KEYS = (("tokens", (2, 4096, 19)), ("params", (2, 4096, 10)), ("est", (4096, 12)),
        ("shpd", (4096, 1323)), ("bndry", (4096, 441)))
NB, STRIDE, BLOCK, L, R = 6, 88, 147, 4096, 21


def blocks(img):
    for b in range(NB * NB):
        iv, ih = divmod(b, NB)
        yield b, img[:, iv * STRIDE:iv * STRIDE + BLOCK, ih * STRIDE:ih * STRIDE + BLOCK]


def memmaps(out: Path, side: str, mode: str):
    return {k: np.lib.format.open_memmap(out / f"{side}_{k}.npy", mode=mode, dtype=np.float32,
                                         shape=(NB * NB,) + s if mode == "w+" else None)
            for k, s in KEYS}


def run_jax(out: Path) -> None:
    import jax
    import jax.numpy as jnp

    from blurry_edges_tpu import models as jmodels
    from blurry_edges_tpu.config import CamConfig, GridConfig, PatchConfig
    from blurry_edges_tpu.eval.pipeline import render_full
    from blurry_edges_tpu.ops import params2etas, unfold
    from blurry_edges_tpu.ops.dfd import DfDSolver
    from blurry_edges_tpu.ops.params import denormalize_global_eval
    from blurry_edges_tpu.train.checkpoint import load_checkpoint
    from blurry_edges_tpu.train.global_precal import local_tokens
    from tests.test_torch_big import smooth_pair

    w = ROOT / "pretrained_weights"
    tn = lambda t: jax.tree.map(np.asarray, t)                           # noqa: E731
    lc, gc = (load_checkpoint(str(w / n)) for n in ("best_run_exp_local_stage",
                                                     "best_run_exp_global_stage_big"))
    lv = {"params": tn(lc["params"]), "batch_stats": tn(lc["batch_stats"])}
    gv = {"params": tn(gc["params"])}
    with open(out / "weights.pkl", "wb") as f:
        pickle.dump((lv, gv), f)
    img = smooth_pair(587, 3)
    np.save(out / "img.npy", img)
    patch, grid = PatchConfig(), GridConfig()
    dfd = DfDSolver.from_config(CamConfig(), patch)
    lm, gm = jmodels.LocalStage(), jmodels.GlobalStage()

    @jax.jit
    def core(block):
        tokens, params = local_tokens(lm, lv, block, patch, grid)
        est = gm.apply(gv, tokens.transpose(1, 0, 2).reshape(1, L, 38), train=False)
        den = denormalize_global_eval(est).reshape(1, 64, 64, 12)
        rend = render_full(den[..., :8], params2etas(den[..., 8:]), unfold(block, R, 2)[None],
                           patch, dfd, 10.39, hard_mask=False)
        return (tokens, params, est[0], rend["patches_shpd"][0].reshape(L, -1),
                rend["local_bndry"][0].reshape(L, -1))

    mm = memmaps(out, "jax", "w+")
    t0 = time.time()
    with jax.default_matmul_precision("highest"):
        for b, blk in blocks(img):
            for (k, _), v in zip(KEYS, core(jnp.asarray(blk))):
                mm[k][b] = np.asarray(v)
            print(f"jax block {b} {time.time() - t0:.0f} s", flush=True)
    for v in mm.values():
        v.flush()


def port_modules(out: Path):
    import torch

    from blurry_edges_tpu_torch.models.global_stage import GlobalStage
    from blurry_edges_tpu_torch.models.local_stage import LocalStage
    from blurry_edges_tpu_torch.models.weights import jax_global_to_torch, jax_local_to_torch

    with open(out / "weights.pkl", "rb") as f:
        lv, gv = pickle.load(f)
    local = LocalStage()
    local.load_state_dict(jax_local_to_torch(lv["params"], lv["batch_stats"]))
    glob = GlobalStage()
    glob.load_state_dict(jax_global_to_torch(gv["params"]))
    return local.eval(), glob.eval(), torch.from_numpy(np.load(out / "img.npy"))


def port_render(est, block):
    import torch

    from blurry_edges_tpu_torch.config import CamConfig, PatchConfig
    from blurry_edges_tpu_torch.eval.pipeline import render_full
    from blurry_edges_tpu_torch.ops.dfd import DfDSolver
    from blurry_edges_tpu_torch.ops.params import denormalize_global_eval
    from blurry_edges_tpu_torch.ops.patchify import unfold
    from blurry_edges_tpu_torch.ops.wedge import params2etas

    patch = PatchConfig()
    den = denormalize_global_eval(torch.as_tensor(est)).reshape(1, 64, 64, 12)
    r = render_full(den[..., :8].contiguous(), params2etas(den[..., 8:]).contiguous(),
                    unfold(block, R, 2)[None], patch, DfDSolver.from_config(CamConfig(), patch),
                    10.39, False)
    return r["patches_shpd"][0].reshape(L, -1).numpy(), r["local_bndry"][0].reshape(L, -1).numpy()


def run_port(out: Path) -> None:
    import torch

    from blurry_edges_tpu_torch.config import GridConfig, PatchConfig
    from blurry_edges_tpu_torch.eval.pipeline import local_tokens

    local, glob, img = port_modules(out)
    mm = memmaps(out, "port", "w+")
    t0 = time.time()
    with torch.inference_mode():
        for b, blk in blocks(img):
            blk = blk.contiguous()
            tokens, params = local_tokens(local, blk[None], PatchConfig(), GridConfig())
            est = glob(tokens[0].permute(1, 0, 2).reshape(1, L, 38))[0]
            shpd, bndry = port_render(est, blk)
            for (k, _), v in zip(KEYS, (tokens[0], params[0], est, shpd, bndry)):
                mm[k][b] = np.asarray(v)
            print(f"port block {b} {time.time() - t0:.0f} s", flush=True)
    for v in mm.values():
        v.flush()


def analyze(out: Path) -> None:
    import torch

    from blurry_edges_tpu_torch.config import PatchConfig
    from blurry_edges_tpu_torch.eval.pipeline_big import _spans, stitch_maps
    from blurry_edges_tpu_torch.ops.params import normalize_token_features, wrap_local_params
    from blurry_edges_tpu_torch.ops.patchify import fold_flat, unfold
    from blurry_edges_tpu_torch.ops.wedge_cuda import wedge_colors_plain

    J, P = memmaps(out, "jax", "r"), memmaps(out, "port", "r")
    HpB = 284
    spans = _spans(*stitch_maps(64, HpB, NB, 10), NB)

    def stitch(arr, C):
        big = np.empty((HpB, HpB, C), np.float32)
        src = np.empty((HpB, HpB, 2), np.int64)
        for b in range(NB * NB):
            I0, I1, l0, l1 = spans[b // NB]
            J0, J1, m0, m1 = spans[b % NB]
            big[I0:I1, J0:J1] = np.asarray(arr[b]).reshape(64, 64, C)[l0:l1, m0:m1]
            li, lj = np.meshgrid(np.arange(l0, l1), np.arange(m0, m1), indexing="ij")
            src[I0:I1, J0:J1, 0], src[I0:I1, J0:J1, 1] = b, li * 64 + lj
        return big, src

    def fold(big, C):
        p = torch.from_numpy(big).reshape(HpB * HpB, R * R, C).permute(2, 0, 1).contiguous()
        cnt = fold_flat(torch.ones(1, HpB * HpB, R * R), 587, 587, R, 2)
        return (fold_flat(p, 587, 587, R, 2) / cnt).permute(1, 2, 0).numpy()

    culprit_blocks = set()
    for key, C in (("shpd", 3), ("bndry", 1)):
        (bj, src), (bp, _) = stitch(J[key], C * R * R), stitch(P[key], C * R * R)
        fj, fp = fold(bj, C), fold(bp, C)
        d = np.abs(fp - fj)
        bad = d > 5e-3 + 5e-3 * np.abs(fj)
        patch_max = np.abs(bp - bj).max(-1)
        culprits = {}
        for y, x, _ in zip(*np.nonzero(bad)):
            I = np.arange(max(0, (y - R) // 2 + 1), min(HpB, y // 2 + 1))
            Jx = np.arange(max(0, (x - R) // 2 + 1), min(HpB, x // 2 + 1))
            i, j = np.unravel_index(patch_max[np.ix_(I, Jx)].argmax(), (len(I), len(Jx)))
            culprits[(I[i], Jx[j])] = culprits.get((I[i], Jx[j]), 0) + 1
        print(f"{key}: {bad.sum()} of {bad.size} entries outside rtol/atol 5e-3 (max "
              f"{d.max():.4f}), from {len(culprits)} patches:")
        for (I, Jx), n in sorted(culprits.items(), key=lambda kv: -patch_max[kv[0]]):
            b, l = src[I, Jx]
            culprit_blocks.add(int(b))
            diff = lambda k, sl=slice(None): np.abs(np.asarray(P[k][b])[..., l, sl]          # noqa: E731
                                                    - np.asarray(J[k][b])[..., l, sl]).max()
            print(f"  patch ({I},{Jx}) = block {b} local {l}: {n} entries, patch max|diff| "
                  f"{patch_max[I, Jx]:.4f}; params {diff('params'):.2e}, tokens geometry "
                  f"{diff('tokens', slice(0, 10)):.2e}, tokens colors "
                  f"{diff('tokens', slice(10, 19)):.2e}, global output "
                  f"{np.abs(P['est'][b][l] - J['est'][b][l]).max():.2e}")

    wraps = sum(int((np.abs(np.asarray(P["params"][b]) - J["params"][b])[..., 4:8] > np.pi).sum())
                for b in range(NB * NB))
    out_tok = [np.abs(np.asarray(P["tokens"][b]) - J["tokens"][b])
               > 2e-4 + 2e-3 * np.abs(np.asarray(J["tokens"][b])) for b in range(NB * NB)]
    print(f"angle wraps (|diff| > pi) over the 36 blocks: {wraps}; token entries outside "
          f"rtol 2e-3 / atol 2e-4: {np.mean(out_tok):.4%}")

    local, glob, img = port_modules(out)
    imgs = dict(blocks(img))
    with torch.inference_mode():
        for b in sorted(culprit_blocks):
            tj, ej = np.asarray(J["tokens"][b]), np.asarray(J["est"][b])
            e_x = glob(torch.from_numpy(tj).permute(1, 0, 2).reshape(1, L, 38))[0].numpy()
            s_x, b_x = port_render(ej, imgs[b].contiguous())
            print(f"block {b}: the port's global stage on JAX's tokens: max|diff| "
                  f"{np.abs(e_x - ej).max():.2e}; the port's render on JAX's global output: shpd "
                  f"{np.abs(s_x - J['shpd'][b]).max():.2e}, bndry "
                  f"{np.abs(b_x - J['bndry'][b]).max():.2e}")
        local64 = local.double()
        for b in sorted(culprit_blocks)[-2:]:
            flat = unfold(imgs[b].contiguous(), R, 2).reshape(-1, R, R, 3)
            p64 = wrap_local_params(local64(flat.double())).reshape(2, L, 10).numpy()
            pj, pp = np.asarray(J["params"][b]), np.asarray(P["params"][b])
            off = lambda a: np.where(np.abs(a - p64) > np.pi, 0, np.abs(a - p64))   # noqa: E731
            par = torch.from_numpy(pj.reshape(-1, 10).copy())
            tok = normalize_token_features(par, wedge_colors_plain(par, flat, PatchConfig()))
            print(f"block {b}: float32 CNN vs float64, port max {off(pp).max():.2e} (p99 "
                  f"{np.quantile(off(pp), 0.99):.2e}), JAX max {off(pj).max():.2e} (p99 "
                  f"{np.quantile(off(pj), 0.99):.2e}); wraps against float64: port "
                  f"{int((np.abs(pp - p64) > np.pi).sum())}, JAX "
                  f"{int((np.abs(pj - p64) > np.pi).sum())}; colors from JAX's parameters by the "
                  f"port's solve vs JAX's tokens: max "
                  f"{np.abs(tok.reshape(2, L, 19).numpy()[..., 10:] - np.asarray(J['tokens'][b])[..., 10:]).max():.2e}")


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("step", choices=("jax", "port", "analyze"))
    p.add_argument("--out", required=True)
    a = p.parse_args()
    out = Path(a.out)
    os.makedirs(out, exist_ok=True)
    {"jax": run_jax, "port": run_port, "analyze": analyze}[a.step](out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
