#!/usr/bin/env python3
"""The port's training-data chain at the reference's size on one CUDA card,
stage by stage, each stage a process of its own through the port's command
line (``python -m blurry_edges_tpu_torch.cli <mode>``):

    python3 datagen_reference_run.py --weights runs/torch_assets/weights [--stages ...]

Stages, in order (``--stages`` picks some):

- ``cuda_baseline``: a process that only takes the card (the floor under
  every stage's host peak: PyTorch's CUDA libraries);
- ``gen_trainval``: 8,000 train and 2,000 val scenes (``--n_train``,
  ``--n_val``) under ``<out>/data``;
- ``cnn_float64``: the local stage of ``--weights`` in float32 against
  the same module in float64 over the first 8 train pairs' 65,536
  patches (``chip_smoke.py::cnn_float64_reading``);
- ``global_precal``: their tokens through the local stage of ``--weights``
  (``pretrained_local_stage.pth`` or ``best_run_exp_local_stage.pth``);
- ``global_train``: one epoch of the global trainer on those tokens, batch
  8, flash attention, into ``<out>/w_global``;
- ``densify_train``: the depth-completion U-Net's trainer with
  ``--pipeline`` (sparse maps of the local and global stages of
  ``--weights`` over the first 1,500 train and 300 val scenes, the
  command line's cap) for ``--densify_epochs`` epochs (the command line's
  own 100 cut), into ``<out>/w_densify``;
- ``gen_test`` / ``gen_test_big``: 200 pairs at 147x147 and 60 at 587x587
  (``--n_test``, ``--n_test_big``);
- ``eval_none``, ``eval_w``, ``eval_pp``, ``eval_big``: the evaluations of
  those sets with the weights of ``--weights``.

For each stage it records the seconds, the peak resident memory of the
host process (``ru_maxrss``) and the peak device memory
(``torch.cuda.max_memory_allocated``), with the stage's own result (the
evaluations' averages), in ``<out>/records/datagen_reference.json``, and
each stage's output in ``<out>/records/datagen_reference_<stage>.log``. The
card's name and power limit head the record. ``<out>`` (default
``runs/datagen_ref``) needs ~28 GB of disk at the default sizes.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
STAGES = ("cuda_baseline", "gen_trainval", "cnn_float64", "global_precal", "global_train",
          "densify_train", "gen_test", "gen_test_big", "eval_none", "eval_w", "eval_pp",
          "eval_big")
MARK = "STAGE_RESULT "


def stage_argv(stage: str, a) -> list:
    out, w = Path(a.out), a.weights
    cuda = ["--cuda", "cuda:0"]
    evals = {"eval_none": [], "eval_w": ["--densify", "w"], "eval_pp": ["--densify", "pp"]}
    if stage == "cuda_baseline":
        return ["cuda_baseline"]
    if stage == "gen_trainval":
        return ["gen_trainval"] + cuda + ["--data_path", str(out / "data"), "--num_sample_train",
                                          str(a.n_train), "--num_sample_val", str(a.n_val)]
    if stage == "global_precal":
        return ["global_precal"] + cuda + ["--data_path", str(out / "data"), "--model_path", w]
    if stage == "global_train":
        return ["global_train"] + cuda + ["--data_path", str(out / "data"), "--model_path",
                                          str(out / "w_global"), "--log_path",
                                          str(out / "logs_global"), "--epoch_num", "1",
                                          "--attn_impl", "flash"]
    if stage == "cnn_float64":
        return ["cnn_float64", w, str(out / "data")]
    if stage == "densify_train":
        return ["densify_train", "--pipeline", "--densify_epochs", str(a.densify_epochs)] + cuda + [
            "--data_path", str(out / "data"), "--model_path", w,
            "--log_path", str(out / "logs_densify")]
    if stage in ("gen_test", "gen_test_big"):
        big = ["--big"] if stage == "gen_test_big" else []
        n = a.n_test_big if big else a.n_test
        return ["gen_test"] + big + cuda + ["--data_path", str(out / "data_test"),
                                            "--num_sample_test", str(n)]
    if stage in evals:
        return ["eval"] + cuda + evals[stage] + [
            "--model_path", w, "--data_path", str(out / "data_test"), "--log_path",
            str(out / f"logs_{stage}"), "--vis_max", "1"]
    if stage == "eval_big":
        return ["eval_big"] + cuda + ["--model_path", w, "--data_path", str(out / "data_test_big"),
                                      "--log_path", str(out / "logs_eval_big"), "--vis_max", "1"]
    raise ValueError(stage)


def run_one(argv: list) -> None:
    """In the stage's own process: the mode, then its peaks as one line."""
    import torch

    sys.path.insert(0, str(ROOT))
    from blurry_edges_tpu_torch import cli

    if argv[0] == "cuda_baseline":      # what a process holds once it has the card
        result = torch.ones(1, device="cuda").sum().item()
    elif argv[0] == "cnn_float64":
        from blurry_edges_tpu_torch.config import GridConfig
        from chip_smoke import cnn_float64_reading

        result = cnn_float64_reading(Path(argv[1]), Path(argv[2]), GridConfig(),
                                     torch.device("cuda", 0))
        print(result, flush=True)
    elif argv[0] == "densify_train":      # the mode's 100 epochs cut to --densify_epochs
        import functools

        from blurry_edges_tpu_torch.train import densify

        j = argv.index("--densify_epochs")
        epochs, argv = int(argv[j + 1]), argv[:j] + argv[j + 2:]
        densify.run_densify_training = functools.partial(densify.run_densify_training,
                                                         epochs=epochs)
        result = cli.MODES[argv[0]](argv[1:])
    else:
        result = cli.MODES[argv[0]](argv[1:])
    torch.cuda.synchronize()
    peaks = {"peak_rss_gib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20,
             "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30}
    if isinstance(result, dict):
        peaks["result"] = {k: (v.tolist() if hasattr(v, "tolist") else v)
                           for k, v in result.items()}
    print(MARK + json.dumps(peaks), flush=True)


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--one":
        run_one(sys.argv[2:])
        return 0
    p = argparse.ArgumentParser()
    p.add_argument("--weights", required=True, help="directory of the committed weights as .pth")
    p.add_argument("--out", default=str(ROOT / "runs" / "datagen_ref"))
    p.add_argument("--stages", nargs="+", default=list(STAGES), choices=STAGES)
    p.add_argument("--n_train", type=int, default=8000)
    p.add_argument("--n_val", type=int, default=2000)
    p.add_argument("--n_test", type=int, default=200)
    p.add_argument("--n_test_big", type=int, default=60)
    p.add_argument("--densify_epochs", type=int, default=3)
    a = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("datagen_reference_run: no CUDA device", file=sys.stderr)
        return 2
    logs = Path(a.out) / "records"
    logs.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    record = {"card": card, "args": vars(a), "stages": {}}
    rec_path = logs / "datagen_reference.json"
    print(f"card: {card}; disk free {shutil.disk_usage(a.out).free / 1e9:.1f} GB", flush=True)
    for stage in a.stages:
        argv = stage_argv(stage, a)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--one"] + argv,
                              cwd=ROOT, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        (logs / f"datagen_reference_{stage}.log").write_text(proc.stdout + proc.stderr)
        row = {"argv": argv, "rc": proc.returncode, "seconds": seconds}
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(MARK)]
        if lines:
            row.update(json.loads(lines[-1][len(MARK):]))
        row["disk_used_gb"] = sum(f.stat().st_size for f in Path(a.out).rglob("*")
                                  if f.is_file()) / 1e9
        record["stages"][stage] = row
        rec_path.write_text(json.dumps(record, indent=1))
        print(f"{stage}: rc {proc.returncode}, {seconds:.1f} s, host peak "
              f"{row.get('peak_rss_gib', float('nan')):.2f} GiB, device peak "
              f"{row.get('peak_device_gib', float('nan')):.2f} GiB, {row['disk_used_gb']:.1f} GB "
              f"on disk [{card}]", flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-3000:], file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
