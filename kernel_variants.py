#!/usr/bin/env python3
"""Time variants of a CUDA kernel of the port beside each other on one card.

    python3 kernel_variants.py colors [--parent DIR] [--source NAME=FILE ...]
    python3 kernel_variants.py render [--parent DIR] [--source NAME=FILE ...]
    python3 kernel_variants.py dq [--parent DIR] [--source NAME=FILE ...]

From the repository root, on a machine with a CUDA card and ``nvcc``. A
variant is the committed source of the kernel (``csrc/wedge_colors.cu``,
``csrc/wedge_render.cu`` or ``csrc/flash_attn_bwd_dq.cu``) with named text
edits: another constant or launch bound, another way to bring the data in,
or an ablation that skips one phase (its output is not checked). ``--parent DIR`` adds the same kernel from another checkout, such
as the parent commit unpacked by ``git archive``, and ``--source NAME=FILE``
another source of it (with the committed headers). Every variant is compiled
by its own ``nvcc`` (the flags of ``ops/_build.py``) into its own library,
all in parallel; ptxas's registers, shared memory and spills are printed for
each. Each variant that computes the function is held against the plain
version at chip_smoke.py's tolerances, then all are timed by CUDA events in
turns, in order and then in reverse, back to back (warm) and, for the wedge
kernels, with the L2 cache flushed before each launch (cold). The colors
kernel's inputs are random parameters and pixels of one pair's 8,192
patches and of four pairs' 32,768, and it is also checked at a ragged P
(8,191), with the pixels' start moved by 1 to 3 floats, and on the
degenerate geometry; the render's are random geometry and pixels on the
serving grid (64x64 patches), one pair and four; dQ's a training chunk,
(2, 8, 4096, 16).
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
import tempfile
from collections import Counter
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
# the mangled-name fragment of the kernel instance timed (the colors
# kernel's R = 21 instance; the others have one instance)
ENTRY = {"colors": "ILi21E", "render": "", "dq": ""}
# kernel -> (source, C entry, {variant: [(old text, new text), ...]})
_COLORS_WAIT = "  cp_async_wait<0>();\n  __syncwarp();\n"
_COLORS_LOOP = ("  for (int n = lane; n < N; n += 32) {\n    float x, y;\n"
                "    wedge::pixel_xy(n, R, step, x, y);\n"
                "    add_pixel(g, x, y, w, k1, k2, px + 3 * n, gram, aty);\n  }\n")
_COLORS_STAGE = "  stage_range(buf, src, 3 * N, lane);\n  cp_async_commit();\n"
_UNROLL2 = [(_COLORS_LOOP, "#pragma unroll 2\n" + _COLORS_LOOP)]
_LEAN_LOOP = [(_COLORS_LOOP, """  const float* v = px + 3 * lane;
  int row = lane / R, col = lane - row * R;
  const int drow = 32 / R, dcol = 32 - drow * R;
  for (int n = lane; n < N; n += 32, v += 96) {
    add_pixel(g, -1.f + (float)col * step, -1.f + (float)row * step, w, k1, k2, v, gram, aty);
    col += dcol;
    row += drow;
    if (col >= R) {
      col -= R;
      ++row;
    }
  }
""")]
_BLOCKS6 = [("constexpr int kMinBlocks = 8;", "constexpr int kMinBlocks = 6;")]
# the patch's trig spread over lanes 0-3, the results shuffled round: one
# fmodf pass of the angles, one more for the signs, one sincosf and one eta
# a lane where every lane took six, four and two (the same values)
_LANE_GEOMETRY = [
    ("// kR > 0: the patch size, fixed at compile time; kR = 0: R_arg", """__device__ __forceinline__ wedge::Geometry geometry_by_lanes(const float q[10], int lane,
                                                            float& k1, float& k2) {
  const unsigned all = 0xffffffffu;
  const int i = lane & 3;
  const float wrapped = wedge::mod_2pi(i == 0 ? q[4] : i == 1 ? q[5] : i == 2 ? q[6] : q[7]);
  const float th1 = __shfl_sync(all, wrapped, 0), ph1 = __shfl_sync(all, wrapped, 1);
  const float th2 = __shfl_sync(all, wrapped, 2), ph2 = __shfl_sync(all, wrapped, 3);
  float s, c;
  sincosf(i == 0 ? th1 : i == 1 ? th1 + ph1 : i == 2 ? th2 : th2 + ph2, &s, &c);
  const float twice = wedge::mod_2pi(wrapped);  // as make_geometry takes the signs
  wedge::Geometry g;
  g.x0 = q[0]; g.y0 = q[1]; g.x1 = q[2]; g.y1 = q[3];
  g.s11 = __shfl_sync(all, s, 0); g.c11 = __shfl_sync(all, c, 0);
  g.s12 = __shfl_sync(all, s, 1); g.c12 = __shfl_sync(all, c, 1);
  g.s21 = __shfl_sync(all, s, 2); g.c21 = __shfl_sync(all, c, 2);
  g.s22 = __shfl_sync(all, s, 3); g.c22 = __shfl_sync(all, c, 3);
  g.sgn1 = __shfl_sync(all, twice, 1) < wedge::kPi ? 1.f : -1.f;
  g.sgn2 = __shfl_sync(all, twice, 3) < wedge::kPi ? 1.f : -1.f;
  const float k = wedge::kInvSqrt2 / wedge::coef_to_eta((lane & 1) ? q[9] : q[8]);
  k1 = __shfl_sync(all, k, 0);
  k2 = __shfl_sync(all, k, 1);
  return g;
}

// kR > 0: the patch size, fixed at compile time; kR = 0: R_arg"""),
    ("""  const wedge::Geometry g = wedge::make_geometry(q, true);
  const float k1 = wedge::kInvSqrt2 / wedge::coef_to_eta(q[8]);
  const float k2 = wedge::kInvSqrt2 / wedge::coef_to_eta(q[9]);""", """  float k1, k2;
  const wedge::Geometry g = geometry_by_lanes(q, lane, k1, k2);""")]
KERNELS = {
    "colors": ("wedge_colors.cu", "wedge_colors_launch", {
        "base": [],
        "lane_geometry": _LANE_GEOMETRY,
        "lane_geometry_lean_loop": _LANE_GEOMETRY + _LEAN_LOOP,
        # the generic instance, R an argument
        "no_r_specialisation": [("if (R == kServingR)", "if (R < 0)")],
        # the distances with four square roots a pixel, as the render takes them
        "four_roots": [("wedge::wedge_dists_sq(g, x, y, w, d1, d2);",
                        "wedge::wedge_dists(g, x, y, w, d1, d2);")],
        "unroll2": _UNROLL2,
        # two pixels a lane in flight at once, at 24 warps an SM (85 registers)
        "unroll2_blocks6": _UNROLL2 + _BLOCKS6,
        "warps8": [("constexpr int kWarps = 4;", "constexpr int kWarps = 8;"),
                   ("constexpr int kMinBlocks = 8;", "constexpr int kMinBlocks = 4;")],
        # 40 warps an SM (at most 51 registers; shared memory allows 10 blocks)
        "blocks10": [("constexpr int kMinBlocks = 8;", "constexpr int kMinBlocks = 10;")],
        # the pixel's row and column stepped, and its values' address, in
        # place of a division and a multiply each pixel (the same coordinates)
        "lean_loop": _LEAN_LOOP,
        "lean_loop_unroll2_blocks6": [(_COLORS_LOOP, _LEAN_LOOP[0][1].replace(
            "  for (", "#pragma unroll 2\n  for ("))] + _BLOCKS6,
        # two commit groups; the first half of the iterations runs once the
        # first has landed
        "copy_halves": [
            (_COLORS_STAGE,
             "  const int half = 3 * 32 * ((N + 63) / 64);\n"
             "  stage_part(buf, src, 0, half, lane);\n  cp_async_commit();\n"
             "  stage_part(buf, src, half, 3 * N, lane);\n  cp_async_commit();\n"),
            (_COLORS_WAIT + _COLORS_LOOP,
             "  cp_async_wait<1>();\n  __syncwarp();\n  int n = lane;\n"
             "  for (; n < half / 3; n += 32) {\n    float x, y;\n"
             "    wedge::pixel_xy(n, R, step, x, y);\n"
             "    add_pixel(g, x, y, w, k1, k2, px + 3 * n, gram, aty);\n  }\n"
             "  cp_async_wait<0>();\n  __syncwarp();\n"
             "  for (; n < N; n += 32) {\n    float x, y;\n"
             "    wedge::pixel_xy(n, R, step, x, y);\n"
             "    add_pixel(g, x, y, w, k1, k2, px + 3 * n, gram, aty);\n  }\n")],
        # all of a lane's 42 values loaded into registers at entry, no shared
        # memory (valid for R = 21 only: 14 iterations at most)
        "register_prefetch": [
            (_COLORS_STAGE + "  const float* px = buf + misalign(src);\n",
             "  constexpr int kIt = kR > 0 ? (kR * kR + 31) / 32 : 14;\n  float v[kIt][3];\n"
             "#pragma unroll\n  for (int i = 0; i < kIt; ++i)\n#pragma unroll\n"
             "    for (int c = 0; c < 3; ++c)\n"
             "      v[i][c] = lane + 32 * i < N ? __ldg(src + (lane + 32 * i) * 3 + c) : 0.f;\n"),
            (_COLORS_WAIT + _COLORS_LOOP,
             "#pragma unroll\n  for (int i = 0; i < kIt; ++i) {\n"
             "    if (lane + 32 * i >= N) break;\n    float x, y;\n"
             "    wedge::pixel_xy(lane + 32 * i, R, step, x, y);\n"
             "    add_pixel(g, x, y, w, k1, k2, v[i], gram, aty);\n  }\n"),
            ("return (size_t)kWarps * warp_floats(R * R) * 4;", "return 0;"),
            ("constexpr int kMinBlocks = 8;", "constexpr int kMinBlocks = 4;")],
        # what the copy alone costs, the arithmetic alone, and the per-patch
        # work alone (geometry, reductions, inverse, the store)
        "ablate_copy_only": [("n < N; n += 32) {\n    float x, y;", "n < 0; n += 32) {\n    float x, y;")],
        "ablate_no_copy": [(_COLORS_STAGE, "")],
        "ablate_patch_only": [(_COLORS_STAGE, ""),
                              ("n < N; n += 32) {\n    float x, y;", "n < 0; n += 32) {\n    float x, y;")],
    }),
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
        report = cs.ptxas_line(f"== k.cu\n{log}", "k.cu", ENTRY[kernel])
        libs[name] = (fn, report)
    return libs


def sass_report(so: Path, entry: str, out: Path) -> str:
    """The instruction count of the first kernel in ``so`` whose mangled
    name holds ``entry`` (or of its first kernel, where none does), and its
    ten commonest opcodes; its SASS is written to ``out``."""
    funcs, cur = {}, None
    for ln in _build.sass(so).splitlines():
        if "Function :" in ln:
            cur = ln.split("Function :", 1)[1].strip() if "_kernel" in ln else None
            if cur:
                funcs[cur] = []
        elif cur:
            funcs[cur].append(ln)
    lines = next((v for k, v in funcs.items() if entry in k), next(iter(funcs.values())))
    out.write_text("\n".join(lines))
    ops = Counter()
    for ln in lines:
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)", ln)
        if m:
            ops[m.group(1)] += 1
    return f"{sum(ops.values())} instructions; " + ", ".join(f"{k} {v}" for k, v in ops.most_common(10))


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


def colors_call(fn, params, pixels, patch_cfg):
    """The color solve by launch function fn, as ops/wedge_cuda.py::
    wedge_colors launches it."""
    colors = torch.empty((params.shape[0], 3, 3), device=params.device)
    rc = fn(params.data_ptr(), pixels.data_ptr(), colors.data_ptr(), params.shape[0],
            patch_cfg.R, patch_cfg.w, patch_cfg.lambda_ridge,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch failed: cudaError {rc}")
    return colors


def colors_inputs(P, R, seed, dev, offset=0):
    """Random raw parameters (P, 10) and pixels (P, R, R, 3), the pixels
    starting ``offset`` floats into their buffer."""
    g = torch.Generator().manual_seed(seed)
    params = (torch.randn((P, 10), generator=g) * 1.5).to(dev)
    buf = torch.rand((P * R * R * 3 + offset,), generator=g).to(dev)
    return params, buf[offset:].view(P, R, R, 3)


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
    ap.add_argument("--sass", type=Path, default=None, metavar="DIR",
                    help="write each variant's SASS into DIR and print its opcode counts")
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
        if args.sass is not None:
            args.sass.mkdir(parents=True, exist_ok=True)
            for name in libs:
                print(f"sass {args.kernel} {name}: " + sass_report(
                    Path(tmp) / name / "k.so", ENTRY[args.kernel],
                    args.sass / f"{args.kernel}_{name}.sass"))
        cases = {}
        if args.kernel == "colors":
            patch_cfg = PatchConfig()
            R = patch_cfg.R
            checks = {"single": colors_inputs(8192, R, cs.SEED, dev),
                      "x4": colors_inputs(32768, R, cs.SEED + 1, dev),
                      "ragged P=8191": colors_inputs(8191, R, cs.SEED + 2, dev)}
            for off in (1, 2, 3):
                checks[f"start +{off} floats"] = colors_inputs(4097, R, cs.SEED + 2 + off, dev, off)
            p0, f0 = checks["single"]
            zero = torch.zeros_like(p0)
            zero[:, 8:] = 2.0
            checks["degenerate"] = (zero, f0)
            for case, (p, f) in checks.items():
                want = wedge_cuda.wedge_colors_plain(p, f, patch_cfg)
                base = colors_call(libs["base"][0], p, f, patch_cfg)
                for name, (fn, _) in libs.items():
                    if name.startswith("ablate"):
                        continue
                    got = colors_call(fn, p, f, patch_cfg)
                    err = cs.compare_colors(got, want)
                    same = "equal" if torch.equal(got, base) else "not equal"
                    print(f"check colors {name} [{case}, P={p.shape[0]}]: max|diff| {err:.3g} ok; "
                          f"bit for bit {same} to base")
            for case in ("single", "x4"):
                p, f = checks[case]
                cases[case] = {name: (lambda fn=fn, p=p, f=f: colors_call(fn, p, f, patch_cfg))
                               for name, (fn, _) in libs.items()}
        elif args.kernel == "render":
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
                        cold = cs.cuda_ms_cold(fns[name], 10) if args.kernel != "dq" else None
                        times[name].append((warm, cold))
                for name in order:
                    print(f"time {args.kernel} {name} [{case}]: " + ", ".join(
                        f"warm {w:.4f} ms" + (f" cold {c:.4f} ms" if c is not None else "")
                        for w, c in times[name]) + f" [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
