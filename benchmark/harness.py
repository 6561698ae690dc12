"""The benchmark's dispatch by name and what every run does around its
kind: the card check, the set-up clock, the reading of the metrics, the
check that no JAX module was loaded, and the result line."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path
from typing import Optional

# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "blurry_edges_tpu")


def cache_env(root: Path) -> dict:
    """Kernel and build caches at fixed paths inside the checkout (the
    program's own library is built into ``blurry_edges_tpu_torch/_build``)."""
    cache = root / ".bench_cache"
    return {"TRITON_CACHE_DIR": str(cache / "triton"),
            "TORCH_EXTENSIONS_DIR": str(cache / "torch_extensions")}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module from its file; its name may hold dots."""
    spec = importlib.util.spec_from_file_location(f"bench_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_entry(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def metrics_for(manifest: dict, cell: str, trace: bool) -> list:
    """The cell's end-to-end metrics (untraced run) or per-layer metrics
    (traced run): those that list the cell, or list no cells. A per-layer
    metric without a list goes where its end-to-end metric goes."""
    e2e = [m for m in manifest["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names else [])]


def forbidden_modules() -> list:
    return sorted({k.split(".")[0] for k in sys.modules} & set(FORBIDDEN))


def nvidia_smi() -> str:
    """The card's name, clocks, power draw and power limit, or why not."""
    q = "name,clocks.sm,clocks.max.sm,power.draw,power.limit,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not read: {e}"


@dataclasses.dataclass
class Context:
    """What a kind's ``run`` gets: the cell, its configuration, traffic mix
    and limits by their files, the run's arguments, and the device."""

    root: Path
    cell: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    t_start: float
    device: object


def context(root: Path, manifest: dict, workload: str, seed: int, seconds: float, trace: bool,
            t_start: float, device) -> tuple:
    """(the kind's module, its Context) for a cell: its configuration
    ``configs/<config>.json``, traffic mix ``traffic/<traffic>.json``,
    kind ``kinds/<kind>.py`` and limits ``limits/<cell>.json``."""
    bench = root / "benchmark"
    cell = cell_entry(manifest, workload)
    config = load_json(bench / "configs" / f"{cell['config']}.json")
    traffic = load_json(bench / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(bench / "limits" / f"{workload}.json")["limits"]
    kind = load_module(bench / "kinds" / f"{traffic['kind']}.py")
    return kind, Context(root, cell, config, traffic, limits, seed, seconds, trace, t_start, device)


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool,
             t_start: float, need_card: bool = True, device: Optional[str] = None) -> int:
    """One run: returns the exit code; prints the result line on success."""
    import torch

    bench = root / "benchmark"
    manifest = load_json(root / "BENCHMARK.json")
    cell = cell_entry(manifest, workload)
    if need_card:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"{workload} needs {cell['chips']} CUDA card(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
        print(f"card: {nvidia_smi()}", file=sys.stderr, flush=True)
    kind, ctx = context(root, manifest, workload, seed, seconds, trace, t_start,
                        torch.device(device or "cuda"))
    rec = kind.run(ctx)
    found = forbidden_modules()
    if found:
        print(f"modules that no run may load were loaded: {', '.join(found)}", file=sys.stderr)
        return 4
    metrics = {}
    for m in metrics_for(manifest, workload, trace):
        value = load_module(bench / "metrics" / f"{m['name']}.py").read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    checks = rec["checks"]
    correct = bool(rec["correct"]) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": rec["attempted"], "failed": rec["failed"],
              "metrics": metrics, "device": rec["device"]}
    if trace and rec.get("breakdown"):
        result["breakdown"] = rec["breakdown"]
    result["checks"] = checks
    if rec.get("numbers"):
        print(f"numbers: {json.dumps(rec['numbers'])}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
