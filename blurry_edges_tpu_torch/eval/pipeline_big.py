"""Block-tiled inference of large images (587x587 and the other 147 + 4k
sizes), the JAX package's ``eval/pipeline_big.py``.

The image pair is cut into 147x147 blocks at block_stride = img - R +
stride - 2 * stride * n_margin_patch (36 blocks at 587x587). The blocks run
the 147x147 core (local tokens, global stage, the render with soft wedge
masks) ``block_chunk`` at a time, as one batch through the networks and
one launch of each wedge kernel. Of each block's patch grid the outputs
that the stitch keeps (interior block edges lose n_margin_patch patches,
edge blocks keep their outer margins: ``stitch_maps``) are copied into the
big patch grid chunk by chunk, and everything is folded once at the big
grid, as reference blurry_edges_test_big.py:142-183 does in a serial
double loop.

Under ``--dp_devices D`` (``parallel/mesh.py``; the JAX package's
``shard_map`` over the block axis) the 36 blocks are padded to a multiple
of D and split contiguously: each rank runs its share in chunks of
min(block_chunk, its share), the big grids of kept patches are put
together on every rank (each patch comes from one block, so a sum of the
ranks' grids, zeros elsewhere, is exact), and each rank folds once.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..config import CamConfig, GridConfig, PatchConfig
from ..utils.device import float32_precision, resolve_device
from ..utils.trace import span
from .pipeline import (InferenceModules, _as_tensor, fold_outputs, make_render_fn, scored,
                       synchronize, timed_groups)

# render outputs and their per-patch trailing shapes (after B, [2,] Hp, Wp)
_RENDER_KEYS = ("patches", "patches_shpd", "patches_refoc", "local_bndry",
                "depth_map", "depth_mask")


def block_geometry(img_size, big_img_size, R: int, stride: int, n_margin: int):
    """Block stride / count (reference blurry_edges_test_big.py:116-117)."""
    img = np.array(img_size)
    big = np.array(big_img_size)
    block_stride = (img - R + stride - 2 * stride * n_margin).astype(int)
    n_block = np.ceil((big - R - 2 * stride * n_margin + stride) / block_stride).astype(int)
    return tuple(block_stride), tuple(n_block)


def stitch_maps(Hp_local: int, Hp_big: int, n_blocks: int, n_margin: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Static source maps for the margin-discard stitch: for each full-grid
    patch row I, which block row and which local patch row supply it.
    Replicates the reference's sequential overwrite bookkeeping
    (blurry_edges_test_big.py:166-183) exactly, including edge blocks keeping
    their outer margins."""
    src_block = np.zeros(Hp_big, dtype=np.int32)
    src_local = np.zeros(Hp_big, dtype=np.int32)
    keep = Hp_local - 2 * n_margin
    for i in range(n_blocks):
        v_s = 1 if i == 0 else 0
        v_e = 1 if i == n_blocks - 1 else 0
        V_s = i * keep + (1 - v_s) * n_margin
        V_e = (i + 1) * keep + (1 + v_e) * n_margin
        V_s_l = (1 - v_s) * n_margin
        V_e_l = (v_e - 1) * n_margin + Hp_local
        rows = np.arange(V_s, V_e)
        src_block[rows] = i
        src_local[rows] = np.arange(V_s_l, V_e_l)
    return src_block, src_local


def _spans(src_block: np.ndarray, src_local: np.ndarray, n_blocks: int):
    """For each block row (or column) i, the big-grid range it supplies and
    the local range it comes from, both contiguous: (I0, I1, l0, l1)."""
    spans = []
    for i in range(n_blocks):
        rows = np.flatnonzero(src_block == i)
        loc = src_local[rows]
        assert np.array_equal(rows, np.arange(rows[0], rows[-1] + 1))
        assert np.array_equal(loc, np.arange(loc[0], loc[0] + len(rows)))
        spans.append((int(rows[0]), int(rows[-1]) + 1, int(loc[0]), int(loc[0]) + len(rows)))
    return spans


def make_big_depth_estimator(mods: InferenceModules, patch_cfg: PatchConfig,
                             block_grid: GridConfig, big_grid: GridConfig,
                             cam: CamConfig, n_margin: int,
                             rho_prime: float = 10.39, depth_thres: float = 0.05,
                             block_chunk: int = None, device="cuda", mesh=None) -> Callable:
    """(2, Hbig, Wbig, 3) pair (numpy or tensor, alpha-normalized) -> the
    big grid's maps with a leading axis of 1 (global_image (1, 2, H, W, 3),
    confidence (1, H, W), depth_final (1, H, W), ...), as the JAX
    ``make_big_depth_estimator`` returns them. ``block_chunk`` blocks run
    through the networks and each wedge kernel at once (default
    ``config.BLOCK_CHUNK``); the result does not depend on it. ``mods`` must
    live on ``device``. ``mesh``: the rank's data mesh; the blocks split
    over its ranks."""
    from ..config import BLOCK_CHUNK
    from ..parallel.mesh import all_reduce, make_mesh

    device = resolve_device(device)
    chunk = int(block_chunk or BLOCK_CHUNK)
    if chunk < 1:
        raise ValueError(f"block_chunk must be positive, got {block_chunk}")
    mods.local_model.eval()
    mods.global_model.eval()
    R, stride = patch_cfg.R, block_grid.stride
    Hb, Wb = block_grid.H, block_grid.W
    HpB, WpB = big_grid.H_patches, big_grid.W_patches
    (bs0, bs1), (nb0, nb1) = block_geometry(
        (Hb, Wb), (big_grid.H, big_grid.W), R, stride, n_margin)
    if (nb0 - 1) * bs0 + Hb != big_grid.H or (nb1 - 1) * bs1 + Wb != big_grid.W:
        raise ValueError("the big size must tile exactly (147 + 4k)")
    rows = _spans(*stitch_maps(block_grid.H_patches, HpB, nb0, n_margin), nb0)
    cols = _spans(*stitch_maps(block_grid.W_patches, WpB, nb1, n_margin), nb1)
    n_blocks = nb0 * nb1
    mesh = mesh or make_mesh(device=device)
    per_rank = -(-n_blocks // mesh.size)          # the blocks padded to a multiple of D
    mine = range(mesh.rank * per_rank, min(n_blocks, (mesh.rank + 1) * per_rank))
    chunk = min(chunk, per_rank)
    render = make_render_fn(mods, patch_cfg, block_grid, cam, False, rho_prime)

    def zero_grid(key):
        pix = (R, R, 3) if key.startswith("patches") else (R, R)
        lead = (1, 2) if key == "patches" else (1,)
        dtype = torch.int32 if key == "depth_mask" else torch.float32
        return torch.zeros(lead + (HpB, WpB) + pix, dtype=dtype, device=device)

    @torch.inference_mode()
    @float32_precision()
    def estimate(img_ny):
        with span("estimator", pairs=1):
            img = _as_tensor(img_ny).to(device=device, dtype=torch.float32)
            blocks = [img[:, iv * bs0:iv * bs0 + Hb, ih * bs1:ih * bs1 + Wb, :]
                      for iv in range(nb0) for ih in range(nb1)]
            st = {k: zero_grid(k) for k in _RENDER_KEYS}
            for c0 in range(mine.start, mine.stop, chunk):
                ids = range(c0, min(c0 + chunk, mine.stop))
                rend = render(torch.stack([blocks[b] for b in ids]))
                with span("stitch"):
                    for i, b in enumerate(ids):
                        I0, I1, l0, l1 = rows[b // nb1]
                        J0, J1, m0, m1 = cols[b % nb1]
                        for k in _RENDER_KEYS:
                            src, dst = rend[k][i], st[k][0]
                            if k == "patches":     # (2, Hp, Wp, R, R, 3)
                                dst[:, I0:I1, J0:J1] = src[:, l0:l1, m0:m1]
                            else:
                                dst[I0:I1, J0:J1] = src[l0:l1, m0:m1]
                del rend
            if mesh.distributed:       # the ranks' grids put together
                with span("stitch"):
                    for k in _RENDER_KEYS:
                        all_reduce(st[k], mesh)
            out = fold_outputs(st, big_grid)
            out["depth_final"] = torch.where(out["confidence"] > depth_thres,
                                             out["global_depth"], 0.0)
            return out

    return estimate


def run_eval_big(args, modules: InferenceModules, visualizer=None,
                 max_images=None, device="cuda", mesh=None) -> Optional[dict]:
    """587x587 dataset evaluation (the JAX package's ``run_eval_big``):
    ``args`` from ``config.get_args("eval", big=True)``, the models on
    ``device``. Same prints, exclusion of empty images and returned dict
    as ``pipeline.run_eval``. ``mesh``: each pair's blocks split over the
    ranks (``make_big_depth_estimator``); rank 0 scores and returns the
    dict, the other ranks return None."""
    from ..config import cam_from_args, grid_from_args, patch_from_args
    from ..data.datasets import TestDataset
    from ..parallel.mesh import make_mesh

    device = resolve_device(device)
    mesh = mesh or make_mesh(getattr(args, "dp_devices", 0), device=device)
    estimate = make_big_depth_estimator(
        modules, patch_from_args(args), grid_from_args(args, big=False),
        grid_from_args(args, big=True), cam_from_args(args), args.n_margin_patch,
        rho_prime=args.rho_prime, block_chunk=getattr(args, "block_chunk", None),
        device=device, mesh=mesh)
    ds = TestDataset(args.data_path)
    n = len(ds) if max_images is None else min(max_images, len(ds))

    estimate(ds[0][0])            # warm-up, outside the timed region
    synchronize(device)
    return scored(args, timed_groups(ds, n, estimate, mesh, group=1), n, mesh, visualizer)
