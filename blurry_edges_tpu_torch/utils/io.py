"""Host-side IO: directories, loss curves, training logs.

Parity: reference utils/util_func.py:23-38 (create_directory, showCurve) and
the flushed text-log format of local_training.py:93-98 /
global_training.py:198-215.
"""

from __future__ import annotations

import os
import shutil

import numpy as np


def create_directory(path: str, overwrite: bool = True) -> None:
    if not os.path.exists(path):
        os.makedirs(path)
    elif overwrite:
        shutil.rmtree(path)
        os.makedirs(path)


def show_curve(log_path: str, points: np.ndarray, figname: str) -> None:
    """Log-scale loss-curve PNG (reference utils/util_func.py:30-38). No-op if
    matplotlib is unavailable."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    plt.figure(figsize=(8, 6))
    plt.xlabel("Epochs")
    plt.ylabel("Average loss")
    plt.yscale("log")
    plt.plot(np.arange(points.shape[0]), points, linestyle="-", color="b", linewidth=2)
    fig = plt.gcf()
    fig.savefig(f"{log_path}/{figname}.png", format="png", bbox_inches="tight", dpi=600)
    plt.close(fig)


class TrainLogger:
    """Flushed text log with the reference's arg dump + per-epoch table layout
    (reference local_training.py:93-98)."""

    def __init__(self, path: str, args=None, append: bool = False):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        resume = append and os.path.exists(path) and os.path.getsize(path) > 0
        self._f = open(path, "at" if resume else "wt")
        if resume:
            return
        if args is not None:
            print("Arguments:", file=self._f, flush=True)
            for arg in vars(args):
                print(f"{arg:<20}: {getattr(args, arg)}", file=self._f, flush=True)
        print("\nTraining:", file=self._f, flush=True)
        print(f'{"Epoch":<10} {"Loss":<20} {"Scheduler patience":<20} {"Learning rate"}',
              file=self._f, flush=True)

    def epoch(self, epoch: int, loss: float, patience: int, lr: float) -> None:
        print(f"{epoch + 1:<10} {loss:<20.10f} {patience:<20} {lr:.4e}",
              file=self._f, flush=True)

    def footer(self, best_epoch: int, best_loss: float) -> None:
        print(f"\n-- Best epoch is the {best_epoch + 1:d}th, with average loss of {best_loss:.10f}",
              file=self._f, flush=True)

    def close(self) -> None:
        self._f.close()
