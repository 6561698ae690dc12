#!/usr/bin/env python3
"""The JAX package's evaluation on the CPU, as the reference that the
PyTorch port's evaluations on the card are held against, and the
comparison of the two logs.

    JAX_PLATFORMS=cpu python jax_eval_reference.py run --data_path DIR [--densify w|pp] [--big] [--max_images N] [--model_path ./pretrained_weights]
    python jax_eval_reference.py compare JAX_LOG PORT_LOG [--first N]
    python jax_eval_reference.py average LOG [LOG ...]

``run`` evaluates the first ``max_images`` pairs of a test set with the
committed weights (the Orbax checkpoints under ``--model_path``) through
the JAX package's ``run_eval`` / ``run_eval_big``, in float32 at the
HIGHEST matmul precision (the port computes float32 with TF32 off), one
block at a time on the big path (``--block_chunk 1`` keeps the CPU's memory
to a few GiB). Its output is the JAX package's per-pair and average lines.

``compare`` reads the per-pair lines of two such logs (the JAX package's
and the port's CLI print the same format), takes the first N pairs, and
prints each log's average over its scored pairs among them, the scored
counts, and the pairs scored by one and not the other. A pair's metrics do
not depend on the other pairs, so the first N pairs of a full-set log are
what a run over N pairs would print.

``average`` pools the per-pair lines of logs of disjoint parts of one test
set (the 587x587 set is evaluated in two halves) into one average over
the scored pairs, with the scored count and the mean of the per-pair
times.
"""

from __future__ import annotations

import argparse
import re
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

LINE = re.compile(r"Image pair #(\d+): delta1 = ?(\S+), delta2 = ?(\S+), delta3 = ?(\S+), "
                  r"RMSE = ?(\S+) cm, AbsRel = ?(\S+) cm")
EMPTY = re.compile(r"Image pair #(\d+): no predicted pixels")
KEYS = ("delta1", "delta2", "delta3", "rmse", "absrel")


def run(args) -> None:
    import jax

    from blurry_edges_tpu.config import get_args
    from blurry_edges_tpu.utils.weights import load_inference_modules

    argv = ["--data_path", args.data_path, "--model_path", args.model_path]
    if args.big:
        argv += ["--block_chunk", "1"]
    elif args.densify:
        argv += ["--densify", args.densify]
    eargs = get_args("eval", big=args.big, argv=argv)
    mods = load_inference_modules(eargs, densify=eargs.densify, big=args.big)
    with jax.default_matmul_precision("highest"):
        if args.big:
            from blurry_edges_tpu.eval.pipeline_big import run_eval_big

            res = run_eval_big(eargs, mods, max_images=args.max_images)
        else:
            from blurry_edges_tpu.eval.pipeline import run_eval

            res = run_eval(eargs, mods, max_images=args.max_images)
    print({k: float(v) for k, v in res.items()}, flush=True)


def read_log(path: str, first: int):
    text = Path(path).read_text()
    scored = {int(m.group(1)): np.array([float(g) for g in m.groups()[1:]])
              for m in LINE.finditer(text) if int(m.group(1)) < first}
    empty = {int(m.group(1)) for m in EMPTY.finditer(text) if int(m.group(1)) < first}
    return scored, empty


def compare(args) -> None:
    logs = {"jax": read_log(args.jax_log, args.first), "port": read_log(args.port_log, args.first)}
    for name, (scored, empty) in logs.items():
        avg = np.mean(list(scored.values()), axis=0) if scored else np.full(5, np.nan)
        n = len(scored) + len(empty)
        print(f"{name}: first {n} pairs, {len(scored)}/{n} scored: " + ", ".join(
            f"{k} {v:.4f}" for k, v in zip(KEYS, avg)))
    a, b = (set(logs[k][0]) for k in ("jax", "port"))
    common = sorted(a & b)
    if common:
        d = np.array([logs["port"][0][j] - logs["jax"][0][j] for j in common])
        print(f"per pair, port - jax over the {len(common)} pairs both scored: mean " + ", ".join(
            f"{k} {v:+.4f}" for k, v in zip(KEYS, d.mean(0))) + "; max |diff| " + ", ".join(
            f"{k} {v:.4f}" for k, v in zip(KEYS, np.abs(d).max(0))))
    print(f"scored by jax only: {sorted(a - b)}; by the port only: {sorted(b - a)}")


def average(args) -> None:
    rows, n, times = [], 0, []
    for path in args.logs:
        scored, empty = read_log(path, 10**9)
        rows += list(scored.values())
        n += len(scored) + len(empty)
        times += [float(t) for t in re.findall(r"time = ?(\S+) s", Path(path).read_text())]
    avg = np.mean(rows, axis=0)
    print(f"{len(rows)}/{n} scored: " + ", ".join(f"{k} {v:.4f}" for k, v in zip(KEYS, avg))
          + f"; mean time {np.mean(times):.4f} s a pair over {len(times)} pairs")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = parser.add_subparsers(dest="what", required=True)
    pr = sub.add_parser("run")
    pr.add_argument("--data_path", required=True)
    pr.add_argument("--model_path", default="./pretrained_weights")
    pr.add_argument("--densify", default=None, choices=["w", "pp"])
    pr.add_argument("--big", action="store_true")
    pr.add_argument("--max_images", type=int, default=None)
    pc = sub.add_parser("compare")
    pc.add_argument("jax_log")
    pc.add_argument("port_log")
    pc.add_argument("--first", type=int, default=10**9)
    pa = sub.add_parser("average")
    pa.add_argument("logs", nargs="+")
    args = parser.parse_args(argv)
    {"run": run, "compare": compare, "average": average}[args.what](args)


if __name__ == "__main__":
    main()
