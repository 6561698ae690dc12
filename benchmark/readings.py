"""Readings for the limits that decide ``correct``, many seeds in one
process: the program's numbers from the cell's own runs (set-up, a short
window, the check), the control's (the reference in TF32 in the
program's place), and the program's under each planted fault that
``--fault`` names (``benchmark/faults.py``), each seed's on one line of
JSON.

    python3 benchmark/readings.py --workload <cell> --seconds <s> \\
        --seeds <n> ... [--control-seeds <n> ...] [--fault <name> ... --fault-seeds <n> ...]

Needs the card, as a run does. Not part of a run."""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)

import torch  # noqa: E402

from benchmark import harness  # noqa: E402


def context(workload: str, seed: int, seconds: float):
    return harness.context(ROOT, harness.load_json(ROOT / "BENCHMARK.json"), workload, seed,
                           seconds, False, time.perf_counter(), torch.device("cuda"))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault", nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    a = p.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    print(f"card: {harness.nvidia_smi()}", flush=True)
    for seed in a.seeds:
        kind, ctx = context(a.workload, seed, a.seconds)
        rec = kind.run(ctx)
        print(json.dumps({"side": "program", "seed": seed, "numbers": rec["numbers"],
                          "correct": rec["correct"], "attempted": rec["attempted"]}), flush=True)
        del rec
        torch.cuda.empty_cache()
    for seed in a.control_seeds:
        kind, ctx = context(a.workload, seed, a.seconds)
        print(json.dumps({"side": "control", "seed": seed, "numbers": kind.control(ctx)}),
              flush=True)
        torch.cuda.empty_cache()
    for name in a.fault:
        import pytest

        from benchmark import faults

        for seed in a.fault_seeds:
            kind, ctx = context(a.workload, seed, a.seconds)
            with pytest.MonkeyPatch.context() as mp:
                getattr(faults, name)(mp)
                rec = kind.run(ctx)
            print(json.dumps({"side": f"fault:{name}", "seed": seed, "numbers": rec["numbers"],
                              "correct": rec["correct"]}), flush=True)
            del rec
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
