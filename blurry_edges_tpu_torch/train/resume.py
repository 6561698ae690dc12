"""Step-granular snapshots of a whole training state, and resume.

One ``.pth`` file holds the model's and the optimizer's state dicts, the
plateau scheduler and the mid-epoch counters (epoch, step, the running loss
sum and count, the best loss and its epoch), so a killed run resumes at
the step it stopped at (the JAX package's train/resume.py:39-103).
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Optional, Tuple

import torch

from .checkpoint import checkpoint_exists, load_checkpoint, save_checkpoint
from .schedules import PlateauScheduler

_MID_KEYS = ("epoch", "step", "loss_sum", "loss_count", "best_loss", "best_epoch")


def save_step_snapshot(path: str, model: torch.nn.Module,
                       optimizer: torch.optim.Optimizer, sched: PlateauScheduler,
                       *, epoch: int, step: int, loss_sum: float,
                       loss_count: int, best_loss: float, best_epoch: int) -> None:
    save_checkpoint(path, {
        "model": model.state_dict(),
        "optimizer": portable_state(optimizer),
        # plain Python numbers: a numpy scalar (the scheduler keeps the
        # metric it was given) would not load with weights_only
        "sched": {k: v.item() if hasattr(v, "item") else v
                  for k, v in dataclasses.asdict(sched).items()},
        "mid": {"epoch": int(epoch), "step": int(step), "loss_sum": float(loss_sum),
                "loss_count": int(loss_count), "best_loss": float(best_loss),
                "best_epoch": int(best_epoch)},
    })


def portable_state(optimizer: torch.optim.Optimizer) -> dict:
    """The optimizer's state dict as any trainer loads it, on any device:
    learning rates as numbers and ``capturable`` off, as the optimizer was
    made (a step held in a CUDA graph turns both on again,
    ``optim.make_capturable``)."""
    state = optimizer.state_dict()
    for group in state["param_groups"]:
        group["lr"] = float(group["lr"])
        if "capturable" in group:
            group["capturable"] = False
    return state


def load_step_snapshot(path: str, model: torch.nn.Module,
                       optimizer: torch.optim.Optimizer
                       ) -> Optional[Tuple[PlateauScheduler, dict]]:
    """Load a snapshot into ``model`` and ``optimizer`` (in place) and return
    (the scheduler, the mid-epoch counters), or None when there is none.
    A file of another layout warns and starts fresh, as the JAX package's
    loader does."""
    if not checkpoint_exists(path):
        return None
    tree = load_checkpoint(path, map_location="cpu")
    if not (isinstance(tree, dict) and {"model", "optimizer", "sched", "mid"} <= set(tree)
            and set(_MID_KEYS) <= set(tree["mid"])):
        print(f"WARNING: {path} is not a step snapshot; starting fresh",
              file=sys.stderr, flush=True)
        return None
    model.load_state_dict(tree["model"])
    optimizer.load_state_dict(tree["optimizer"])
    return PlateauScheduler(**tree["sched"]), dict(tree["mid"])
