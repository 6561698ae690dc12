#!/usr/bin/env python3
"""Sweep ``--block_chunk`` of the port's 587x587 estimator on one CUDA card.

    python3 big_chunk_sweep.py [--chunks 1 2 4 6 9 12 18 36] [--dtypes float32 bfloat16] [--reps 3]

Seeded random full-width weights (``models/weights.py::random_modules``)
and a seeded 587x587 pair. For each compute dtype and chunk it times
``reps`` calls of ``make_big_depth_estimator`` after one warm-up call (host
clock around calls that end in ``torch.cuda.synchronize()``, the input a
numpy array, as ``run_eval_big`` times a pair), with the peak device memory
(``torch.cuda.max_memory_allocated``) and the wedge kernels' launches of a
call. A chunk that does not fit the card is reported as out of memory and
the sweep goes on. Prints a line per run, the card's name and power limit,
and a JSON summary last.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from blurry_edges_tpu_torch.config import CamConfig, GridConfig, PatchConfig  # noqa: E402
from blurry_edges_tpu_torch.eval.pipeline_big import make_big_depth_estimator  # noqa: E402
from blurry_edges_tpu_torch.ops import wedge_cuda  # noqa: E402
from blurry_edges_tpu_torch.models.weights import random_modules  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--chunks", type=int, nargs="+", default=[1, 2, 4, 6, 9, 12, 18, 36])
    parser.add_argument("--dtypes", nargs="+", default=["float32", "bfloat16"],
                        choices=["float32", "bfloat16"])
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("big_chunk_sweep: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(args.seed)
    yy, xx = np.mgrid[0:587, 0:587].astype(np.float32) / 587
    base = np.stack([0.3 + 0.5 * xx, 0.2 + 0.6 * yy, 0.5 * (xx + yy)], -1)
    pair = np.clip(np.stack([base, base[::-1]]) + rng.normal(0, 0.05, (2, 587, 587, 3)),
                   0, 1).astype(np.float32)
    rows = []
    for dtype in args.dtypes:
        mods = random_modules(torch.Generator().manual_seed(args.seed), dev,
                              dtype=getattr(torch, dtype))
        for chunk in args.chunks:
            est = make_big_depth_estimator(mods, PatchConfig(), GridConfig(),
                                           GridConfig(H=587, W=587), CamConfig(), 10,
                                           block_chunk=chunk, device=dev)
            row = dict(dtype=dtype, chunk=chunk)
            try:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                est(pair)
                torch.cuda.synchronize()
                wedge_cuda.reset_launch_counts()
                times = []
                for _ in range(args.reps):
                    t0 = time.perf_counter()
                    est(pair)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                row.update(s_per_pair=times, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                           launches_per_call={k: v // args.reps for k, v in
                                              wedge_cuda.launch_counts().items()})
                print(f"{dtype} block_chunk {chunk}: {min(times):.4f}-{max(times):.4f} s a pair, "
                      f"peak {row['peak_gib']:.2f} GiB, launches a call "
                      f"{row['launches_per_call']} [{card}]", flush=True)
            except torch.cuda.OutOfMemoryError:
                row.update(out_of_memory=True)
                print(f"{dtype} block_chunk {chunk}: out of memory [{card}]", flush=True)
            rows.append(row)
            del est
        del mods
        torch.cuda.empty_cache()
    print(card)
    print(json.dumps({"card": card, "sweep": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
