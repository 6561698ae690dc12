"""The numbers that decide ``correct``: the program's outputs against the
plain reference's, each number the worst over what was compared.

Serving (per pair, the maps the user is served):
- ``conf_mean_abs``: the mean over pixels of |confidence - reference|;
- ``depth_rel_p50``: the median, over the pixels the reference's wedges
  cover (its confidence above 0), of |global depth - reference| /
  |reference|: the folded depth before the densify;
- ``depth_off_share``: the share of those pixels whose relative gap
  passes ``OFF`` (1e-3): a fault confined to a region (a wrong block of
  the 587x587 stitch, a depth-only fault in part of the render), which
  the median cannot see;
- ``densify_gap``: the largest |served depth - the reference's densify of
  the program's own global depth and confidence| over the largest of the
  latter: the densify stage (the U-Net, or the threshold) held alone,
  from the program's own state, since a knife-edge flip of the global
  depth moves the whole U-Net output.

Training (the trainer's first three steps from the same weights, batches
and dropout seeds):
- ``loss_rel``: the largest |loss - reference| / |reference| of the steps;
- ``grad_gap``: over the parameters, the largest gap between the norm of
  the program's first gradient as its optimizer got it (its first moment
  after one step over 1 - beta1) and the reference's, over the larger of
  that parameter's reference norm and the median parameter's;
- ``change_gap``: the same of each parameter's change over the three
  steps, leaving out parameters whose reference gradient is under a
  thousandth of the median parameter's (they move by round-off alone);
  ``left_out`` counts those parameters;
- ``loss1_rel``: the first step's loss alone. AdamW's first step moves
  every parameter by about the learning rate whatever its gradient's size,
  so parameters whose gradient is rounding move the way rounding picks and
  the later steps' losses read that by more than TF32 moves them on other
  seeds; the first loss precedes any update;
- ``grad_gap_p50``, ``change_gap_p50``: the median parameter's gaps, read
  beside the worst to tell one parameter's noise from a whole seed's.

A cell's limits (``limits/<cell>.json``) name the numbers it compares."""

from __future__ import annotations

import numpy as np

# a covered pixel's relative gap of the folded depth past which it is off
OFF = 1e-3


def serve_numbers(got: dict, want: dict, densified: np.ndarray) -> dict:
    """got / want: {'depth_final', 'confidence', 'global_depth'} arrays
    (H, W) of one pair, the program's and the reference's; ``densified``:
    the reference's densify of got's global depth and confidence."""
    f64 = {k: np.asarray(v, np.float64) for k, v in got.items()}
    r64 = {k: np.asarray(v, np.float64) for k, v in want.items()}
    covered = r64["confidence"] > 0
    gd, rgd = f64["global_depth"][covered], r64["global_depth"][covered]
    rel = np.abs(gd - rgd) / np.maximum(np.abs(rgd), 1e-30)
    dref = np.asarray(densified, np.float64)
    return dict(conf_mean_abs=float(np.abs(f64["confidence"] - r64["confidence"]).mean()),
                depth_rel_p50=float(np.median(rel)) if rel.size else 0.0,
                depth_off_share=float((rel > OFF).mean()) if rel.size else 0.0,
                densify_gap=float(np.abs(f64["depth_final"] - dref).max()
                                  / max(np.abs(dref).max(), 1e-30)))


def worst(rows: list) -> dict:
    return {k: max(r[k] for r in rows) for k in rows[0]} if rows else {}


def _gaps(a: dict, b: dict, keep=None) -> np.ndarray:
    """| |a_k| - |b_k| | / max(|b_k|, median_k |b_k|) for each kept key k."""
    keys = [k for k in b if keep is None or keep[k]]
    na = np.array([np.linalg.norm(np.asarray(a[k], np.float64)) for k in keys])
    nb = np.array([np.linalg.norm(np.asarray(b[k], np.float64)) for k in keys])
    return np.abs(na - nb) / np.maximum(np.maximum(nb, np.median(nb)), 1e-30)


def train_numbers(losses, ref_losses, grads, ref_grads, change, ref_change) -> dict:
    """Losses of the steps; first gradients, and parameter changes over the
    steps, both {name: array}."""
    gn = {k: float(np.linalg.norm(np.asarray(v, np.float64))) for k, v in ref_grads.items()}
    med = float(np.median(list(gn.values())))
    keep = {k: gn[k] >= 1e-3 * med for k in gn}
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    g, c = _gaps(grads, ref_grads), _gaps(change, ref_change, keep)
    return dict(loss_rel=max(rel), loss1_rel=rel[0], grad_gap=float(g.max()),
                grad_gap_p50=float(np.median(g)), change_gap=float(c.max()),
                change_gap_p50=float(np.median(c)), left_out=len(keep) - sum(keep.values()))
