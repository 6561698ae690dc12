#!/usr/bin/env python3
"""Time variants of a CUDA kernel of the port beside each other on one card.

    python3 kernel_variants.py render [--parent DIR] [--source NAME=FILE ...]
    python3 kernel_variants.py dq [--parent DIR] [--source NAME=FILE ...]

From the repository root, on a machine with a CUDA card and ``nvcc``. A
variant is the committed source of the kernel (``csrc/wedge_render.cu`` or
``csrc/flash_attn_bwd_dq.cu``) with named text edits: another constant or
launch bound, or an ablation that skips one phase (its output is not
checked). ``--parent DIR`` adds the same kernel from another checkout, such
as the parent commit unpacked by ``git archive``, and ``--source NAME=FILE``
another source of it (with the committed headers). Every variant is compiled
by its own ``nvcc`` (the flags of ``ops/_build.py``) into its own library,
all in parallel; ptxas's registers, shared memory and spills are printed for
each. Each variant that computes the function is held against the plain
version at chip_smoke.py's tolerances, then all are timed by CUDA events in
turns, in order and then in reverse, back to back (warm) and, for the
render, with the L2 cache flushed before each launch (cold). The render's
inputs are random geometry and pixels on the serving grid (64x64 patches),
one pair and four; dQ's a training chunk, (2, 8, 4096, 16).
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from blurry_edges_tpu_torch.config import CamConfig, PatchConfig  # noqa: E402
from blurry_edges_tpu_torch.ops import _build  # noqa: E402
from blurry_edges_tpu_torch.ops import flash_attention as fa  # noqa: E402
from blurry_edges_tpu_torch.ops import wedge_cuda  # noqa: E402
from blurry_edges_tpu_torch.ops.dfd import DfDSolver  # noqa: E402

CSRC = "blurry_edges_tpu_torch/csrc"
# kernel -> (source, C entry, {variant: [(old text, new text), ...]})
KERNELS = {
    "render": ("wedge_render.cu", "wedge_render_launch", {
        "base": [],
        "pass1_unroll2": [("  for (int n = lane; n < N; n += 32) {\n    float x, y, d1, d2, uA[3]",
                           "#pragma unroll 2\n  for (int n = lane; n < N; n += 32) {\n"
                           "    float x, y, d1, d2, uA[3]")],
        "coords_incremental": [
            ("bool own1 = false, own2 = false;\n  for (int n = lane; n < N; n += 32) {",
             "bool own1 = false, own2 = false;\n  int row = lane / R, cl = lane - row * R;\n"
             "  const int drow = 32 / R, dcol = 32 - drow * R;\n"
             "  for (int n = lane; n < N; n += 32) {"),
            ("    wedge::pixel_xy(n, R, step, x, y);\n    wedge::wedge_dists(g, x, y, k.w, d1, d2);\n"
             "    const float hA1",
             "    x = -1.f + (float)cl * step;\n    y = -1.f + (float)row * step;\n"
             "    cl += dcol;\n    row += drow;\n    if (cl >= R) { cl -= R; ++row; }\n"
             "    wedge::wedge_dists(g, x, y, k.w, d1, d2);\n    const float hA1")],
        "pass2_unroll4": [("  for (int n = lane; n < N; n += 32) {\n    const float a1",
                           "#pragma unroll 4\n  for (int n = lane; n < N; n += 32) {\n    const float a1")],
        "ablate_pass1_only": [("  for (int n = lane; n < N; n += 32) {\n    const float a1",
                               "  for (int n = lane; n < N - N; n += 32) {\n    const float a1")],
    }),
    "dq": ("flash_attn_bwd_dq.cu", "flash_attn_bwd_dq_launch", {
        "base": [],
        "bounds1": [("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads)")],
        "sub64": [("constexpr int kSub = 32;", "constexpr int kSub = 64;"),
                  ("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads)")],
        "sub64_bounds2": [("constexpr int kSub = 32;", "constexpr int kSub = 64;")],
    }),
}


def variant_sources(kernel: str, parent: Path | None, extra=()) -> dict:
    """Variant name -> (source text, directory of its headers); extra: NAME=FILE."""
    source, _, edits = KERNELS[kernel]
    text = (ROOT / CSRC / source).read_text()
    out = {}
    for name, subs in edits.items():
        t = text
        for old, new in subs:
            if t.count(old) < 1:
                raise SystemExit(f"variant {name}: {old!r} not in {source}")
            t = t.replace(old, new)
        out[name] = (t, ROOT / CSRC)
    if parent is not None:
        # the dQ kernel's file was flash_attn_bwd.cu before it was renamed
        names = [source] + (["flash_attn_bwd.cu"] if kernel == "dq" else [])
        found = next(parent / CSRC / n for n in names if (parent / CSRC / n).exists())
        out["parent"] = (found.read_text(), parent / CSRC)
    for item in extra:
        name, path = item.split("=", 1)
        out[name] = (Path(path).read_text(), ROOT / CSRC)
    return out


def build(variants: dict, kernel: str, tmp: Path) -> dict:
    """Variant name -> (ctypes library, ptxas report), compiled in parallel."""
    _, entry, _ = KERNELS[kernel]
    nvcc, procs = _build._nvcc(), {}
    for name, (text, headers) in variants.items():
        d = tmp / name
        d.mkdir()
        for h in headers.glob("*.cuh"):
            shutil.copy(h, d)
        (d / "k.cu").write_text(text)
        cmd = [nvcc, *_build.FLAGS, "-shared", "-o", str(d / "k.so"), str(d / "k.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on variant {name}:\n{log}")
        lib = ctypes.CDLL(str(tmp / name / "k.so"))
        fn = getattr(lib, entry)
        fn.argtypes = _build._SIGNATURES[entry]
        fn.restype = ctypes.c_int
        report = cs.ptxas_line(f"== k.cu\n{log}", "k.cu")
        libs[name] = (fn, report)
    return libs


def render_call(fn, xy, etas, ip, patch_cfg, dfd, hard=False):
    """The render by launch function fn, as ops/wedge_cuda.py::wedge_render
    launches it."""
    B, Hp, Wp = xy.shape[:3]
    R, dev = patch_cfg.R, xy.device
    out = dict(patches=torch.empty((B, 2, Hp, Wp, R, R, 3), device=dev),
               patches_shpd=torch.empty((B, Hp, Wp, R, R, 3), device=dev),
               patches_refoc=torch.empty((B, Hp, Wp, R, R, 3), device=dev),
               local_bndry=torch.empty((B, Hp, Wp, R, R), device=dev),
               depth_map=torch.empty((B, Hp, Wp, R, R), device=dev),
               depth_mask=torch.empty((B, Hp, Wp, R, R), dtype=torch.int32, device=dev))
    rc = fn(xy.data_ptr(), etas.data_ptr(), ip.data_ptr(), out["patches"].data_ptr(),
            out["patches_shpd"].data_ptr(), out["patches_refoc"].data_ptr(),
            out["local_bndry"].data_ptr(), out["depth_map"].data_ptr(),
            out["depth_mask"].data_ptr(), B, Hp * Wp, R, patch_cfg.w, patch_cfg.lambda_ridge,
            int(hard), cs.RHO_PRIME, 0.07**2, dfd.numerator, dfd.denominator_constant,
            dfd.denominator_factor, dfd.denominator_factor_root, dfd.intercept, dfd.s,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch failed: cudaError {rc}")
    return out


def dq_call(fn, q, k, v, dout, lse, di):
    B, H, L, _ = q.shape
    dq = torch.empty_like(q)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            di.data_ptr(), dq.data_ptr(), B * H, L, cs.FLASH_SCALE,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch failed: cudaError {rc}")
    return dq


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernel", choices=sorted(KERNELS))
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--source", action="append", default=[], metavar="NAME=FILE")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_variants: needs a CUDA card", file=sys.stderr)
        return 2
    card = cs.card_line()
    dev = torch.device("cuda", 0)
    variants = variant_sources(args.kernel, args.parent, args.source)
    with tempfile.TemporaryDirectory(prefix="kernel_variants_") as tmp:
        libs = build(variants, args.kernel, Path(tmp))
        for name, (_, report) in libs.items():
            print(f"ptxas {args.kernel} {name}: {report}")
        cases = {}
        if args.kernel == "render":
            patch_cfg = PatchConfig()
            dfd = DfDSolver.from_config(CamConfig(), patch_cfg)
            for case, B in (("single", 1), ("x4", 4)):
                xy, etas, ip = cs.random_render_inputs(B, 64, 64, patch_cfg.R, cs.SEED + B, dev)
                cases[case] = {name: (lambda fn=fn, a=(xy, etas, ip): render_call(
                    fn, *a, patch_cfg, dfd)) for name, (fn, _) in libs.items()}
                for name, (fn, _) in libs.items():
                    if name.startswith("ablate"):
                        continue
                    err = max(cs.compare_render(
                        render_call(fn, xy, etas, ip, patch_cfg, dfd, hard),
                        wedge_cuda.wedge_render_plain(xy, etas, ip, patch_cfg, dfd, cs.RHO_PRIME,
                                                      hard)) for hard in (False, True))
                    print(f"check render {name} [{case}, both masks]: max|diff| {err:.3g} ok")
        else:
            q, k, v, dout = cs.flash_inputs(cs.FLASH_SHAPE, cs.SEED + 7, dev)
            o, lse = fa.flash_attention_fwd(q, k, v, cs.FLASH_SCALE)
            di = (o * dout).sum(-1)
            want = fa.flash_attention_bwd_plain(q, k, v, o, lse, dout, cs.FLASH_SCALE)[0]
            scale = max(1.0, want.abs().max().item())
            cases["chunk"] = {}
            for name, (fn, _) in libs.items():
                err = (dq_call(fn, q, k, v, dout, lse, di) - want).abs().max().item()
                cs.check(err < 1e-4 * scale, f"dq {name}: max|diff| {err}")
                print(f"check dq {name}: max|diff| {err:.3g} ok")
                cases["chunk"][name] = lambda fn=fn: dq_call(fn, q, k, v, dout, lse, di)
        with torch.inference_mode():
            for case, fns in cases.items():
                order = list(fns)
                times = {name: [] for name in order}
                for turn in (order, order[::-1]):
                    for name in turn:
                        warm = cs.cuda_ms(fns[name], 30)
                        cold = cs.cuda_ms_cold(fns[name], 10) if args.kernel == "render" else None
                        times[name].append((warm, cold))
                for name in order:
                    print(f"time {args.kernel} {name} [{case}]: " + ", ".join(
                        f"warm {w:.4f} ms" + (f" cold {c:.4f} ms" if c is not None else "")
                        for w, c in times[name]) + f" [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
