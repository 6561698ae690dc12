"""The global stage's trainer (reference global_training.py:11-225, the JAX
package's train/global_.py): the 7-term loss on the flat layout (fields (..., L, N)
with L = Hp*Wp tokens and N = R*R pixels), the two-phase gamma schedule,
AdamW lr 1e-4 with the global gradient norm clipped at 1.0, batch 8,
ReduceLROnPlateau(factor .975, patience 5, min 50%) stepped only from epoch
dynamic_epoch[1] on, best-val checkpoints, step snapshots with mid-epoch
resume, seed 1898. Training solves the colors on the clean images and
validation on the noisy ones (reference :210 vs :166).
"""

from __future__ import annotations

import functools
import math
import os
import time
from typing import Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..config import GridConfig, PatchConfig
from ..models.global_stage import GlobalStage
from ..ops.dfd import DfDSolver
from ..ops.params import denormalize_global_train
from ..ops.patchify import fold_count, fold_flat, unfold_flat_cm
from ..ops.sobel import image_derivative, image_derivative_flat
from ..parallel.mesh import Mesh, all_reduce, make_mesh, mean_gradients
from ..ops.wedge import (boundary_distance_field_flat, depth_masks_flat,
                         indicator_flat, inverse_3x3, normalized_gaussian,
                         params2dists_flat)
from ..utils.device import float32_precision, resolve_device
from ..utils.seeding import fold_in
from ..utils.trace import profiling, span
from .optim import (clip_by_global_norm_, make_capturable, make_optimizer, set_lr,
                    xavier_reinit)

GAMMA_ORDER = ("color", "color_cons", "bndry_cons", "smthns", "smthns_cons",
               "bndry_loc", "depth")
# samples a chunk of the trainer's batch holds (gradient accumulation)
CHUNK_SAMPLES = 2


def gammas_to_array(g: Dict[str, float], device=None) -> torch.Tensor:
    return torch.tensor([g[k] for k in GAMMA_ORDER], dtype=torch.float32,
                        device=device)


def global_loss_terms(est, img_for_colors, img_gt, bndry_dist, deri, bndry_depth,
                      patch_cfg: PatchConfig, grid: GridConfig, dfd: DfDSolver,
                      hard_mask: bool = False):
    """The loss terms of reference global_training.py:93-157, unweighted, on
    the flat layout (the JAX package's ``global_loss_terms``).

    est (B, L, 12) raw global-stage outputs; images (B, 2, H, W, 3);
    bndry_dist and bndry_depth (B, H, W); deri (B, 2, H-2, W-2, 3).

    Returns (terms (6,): the batch means of color, color_cons, bndry_cons,
    smthns, smthns_cons, bndry_loc; depth_S, depth_N: the masked squared
    depth error's sum and the mask's count, kept apart so chunks compose
    exactly: equal-size chunk means average, the depth term is
    sum(S) / sum(N)). ``hard_mask`` supervises the depth on the hard
    wedge-side masks (the 'w' variant) instead of the near-boundary band.
    The folded global maps the consistency terms compare against carry no
    gradient.
    """
    B = est.shape[0]
    Hp, Wp, R, H, W, stride = (grid.H_patches, grid.W_patches, grid.R,
                               grid.H, grid.W, grid.stride)
    L, N = Hp * Wp, R * R
    BL = B * L
    dtype, dev = est.dtype, est.device
    est = est.reshape(BL, 12)
    xy_angles, etas = denormalize_global_train(est)      # (BL,8), (BL,4)

    coords = torch.linspace(-1.0, 1.0, R, dtype=dtype, device=dev)
    yg, xg = torch.meshgrid(coords, coords, indexing="ij")
    d1, d2 = params2dists_flat(xy_angles, xg.reshape(-1), yg.reshape(-1),
                               patch_cfg.w)              # (BL,N)

    def memberships(e1, e2):
        h1 = indicator_flat(d1, e1)
        h2 = indicator_flat(d2, e2)
        return torch.stack([(1.0 - h1) * (1.0 - h2), h1 * (1.0 - h2), h2], dim=0)

    U = torch.stack([memberships(etas[:, 0], etas[:, 1]),
                     memberships(etas[:, 2], etas[:, 3])], dim=0)  # (2,3,BL,N)

    def unfold_flat(imgs, r):
        """(B, 2, h, w, C) -> (2, C, BL, r*r) channel-major flat patches."""
        pf = unfold_flat_cm(imgs.reshape((B * 2,) + imgs.shape[2:]), r, stride)
        return pf.reshape(B, 2, 3, L, r * r).permute(1, 2, 0, 3, 4).reshape(2, 3, BL, r * r)

    def unfold_flat_1c(m, r=R):
        """(B, h, w) -> (BL, r*r)."""
        return unfold_flat_cm(m[..., None], r, stride).reshape(BL, r * r)

    y = unfold_flat(img_for_colors, R)                   # (2,C,BL,N)
    gt_patches = unfold_flat(img_gt, R)

    # joint ridge solve across the pair (reference global_training.py:62-67)
    gram = {(i, j): (U[:, i] * U[:, j]).sum(dim=(0, -1))
            for i in range(3) for j in range(i, 3)}
    At_A = torch.stack([
        torch.stack([gram[(min(i, j), max(i, j))] for j in range(3)], dim=-1)
        for i in range(3)], dim=-2)                      # (BL,3,3)
    At_y = torch.stack([
        torch.stack([(U[:, k] * y[:, c]).sum(dim=(0, -1)) for c in range(3)], dim=-1)
        for k in range(3)], dim=-2)                      # (BL,3k,3c)
    ridge = patch_cfg.lambda_ridge * torch.eye(3, dtype=dtype, device=dev)
    inv = inverse_3x3(At_A + ridge)
    colors = (inv[..., :, :, None] * At_y[..., None, :, :]).sum(-2)

    # rendered pair patches (2,C,BL,N)
    patches = sum(U[:, k][:, None] * colors[:, k, :].T[None, :, :, None]
                  for k in range(3))

    local_bndry = normalized_gaussian(boundary_distance_field_flat(d1, d2))  # (BL,N)

    dep1 = dfd.etas2depth(etas[:, 0], etas[:, 2])        # (BL,)
    dep2 = dfd.etas2depth(etas[:, 1], etas[:, 3])
    dmask = depth_masks_flat(d1, d2, hard=hard_mask)     # (BL,N) int
    depth_map = torch.where(dmask == 1, dep1[:, None],
                            torch.where(dmask == 2, dep2[:, None], 0.0))

    # the detached folded global maps (reference :95-105)
    count = fold_count(H, W, R, stride, dtype, dev)
    pg = patches.detach().reshape(2, 3, B, L, N).permute(2, 0, 1, 3, 4).reshape(B * 6, L, N)
    gi = fold_flat(pg, H, W, R, stride).reshape(B, 2, 3, H, W)
    global_image = torch.movedim(gi, 2, -1).reshape(B * 2, H, W, 3) / count[:, :, None]
    bg = local_bndry.detach().reshape(B, L, N)
    global_bndry = fold_flat(bg, H, W, R, stride) / count        # (B,H,W)

    # 1) color (reference :130)
    t_color = ((gt_patches - patches) ** 2).sum(1).mean()

    # 2) color consistency against the detached folded pair (reference :95-99)
    gi_patches = unfold_flat(global_image.reshape(B, 2, H, W, 3), R)
    t_color_cons = ((patches - gi_patches) ** 2).sum(1).mean()

    # 3) boundary consistency (reference :101-105)
    gb_patches = unfold_flat_1c(global_bndry)
    t_bndry_cons = ((local_bndry - gb_patches) ** 2).mean()

    # 4-5) smoothness terms (reference :107-116)
    patches_deri = image_derivative_flat(patches, R)             # (2,C,BL,N2)
    gt_deri_patches = unfold_flat(deri, R - 2)
    gi_deri = image_derivative(global_image)                     # (2B,H-2,W-2,3)
    gi_deri_patches = unfold_flat(gi_deri.reshape(B, 2, H - 2, W - 2, 3), R - 2)
    t_smthns = ((patches_deri - gt_deri_patches) ** 2).sum(1).mean()
    t_smthns_cons = ((patches_deri - gi_deri_patches) ** 2).sum(1).mean()

    # 6) boundary localization (reference :118-122)
    bd = unfold_flat_1c(torch.log2(bndry_dist + 1.0))
    t_bndry_loc = ((bd * local_bndry) ** 2).mean()

    # 7) masked depth (reference :124-128), as (sum, count)
    bdep = unfold_flat_1c(bndry_depth)
    dmask_f = torch.where(bdep == 0, 0.0, torch.where(dmask == 0, 0.0, 1.0))
    depth_S = (((depth_map - bdep) * dmask_f) ** 2).sum()
    depth_N = dmask_f.sum()

    terms = torch.stack([t_color, t_color_cons, t_bndry_cons, t_smthns,
                         t_smthns_cons, t_bndry_loc])
    return terms, depth_S, depth_N


def global_loss(est, img_for_colors, img_gt, bndry_dist, deri, bndry_depth,
                gammas, patch_cfg: PatchConfig, grid: GridConfig, dfd: DfDSolver,
                hard_mask: bool = False):
    """The weighted 7-term loss (reference global_training.py:130-139);
    gammas (7,) in GAMMA_ORDER."""
    terms, depth_S, depth_N = global_loss_terms(
        est, img_for_colors, img_gt, bndry_dist, deri, bndry_depth,
        patch_cfg, grid, dfd, hard_mask=hard_mask)
    return (gammas[:6] * terms).sum() + gammas[6] * depth_S / depth_N


def tokens_from_params_src(params_src):
    """params_src (B, 2, L, 19) -> global-stage input (B, L, 38) (reference
    global_training.py:208)."""
    B, _, L, F = params_src.shape
    return torch.movedim(params_src, 1, 2).reshape(B, L, 2 * F)


def expand_compact_batch(batch):
    """The loss inputs from a compact batch (the JAX package's layout):
    imgs_u8 (B,2,H,W,3) uint8 clean photon counts, so img_gt = imgs_u8/255;
    deri = image_derivative(img_gt) (the Sobel operator is linear, so this
    is the dataset's derivative map); ny_u8 noisy photon counts over alpha;
    bndry_dist as integers; input_param (bf16 at rest) in float32. A batch
    that is already expanded passes through."""
    if "imgs_u8" not in batch:
        return batch
    img_gt = batch["imgs_u8"].to(torch.float32) / 255.0        # (B,2,H,W,3)
    B, _, H, W, _ = img_gt.shape
    deri = image_derivative(img_gt.reshape(B * 2, H, W, 3)).reshape(
        B, 2, H - 2, W - 2, 3)
    out = {"input_param": batch["input_param"].to(torch.float32), "img_gt": img_gt,
           "bndry_dist": batch["bndry_dist"].to(torch.float32),
           "deri": deri, "bndry_depth": batch["bndry_depth"]}
    if "ny_u8" in batch:
        a = batch["alpha"].reshape((-1,) + (1,) * 4)
        out["img_ny"] = batch["ny_u8"].to(torch.float32) / a
    return out


def compact_arrays(ds, include_ny: bool):
    """Host-side: a dataset with the arrays of ShapeDataset(mode='global')
    (alpha, img_gt, input_param, bndry_dist, bndry_depth[, img_ny]) ->
    compact numpy arrays for ``expand_compact_batch``."""
    a = ds.alpha.reshape((-1,) + (1,) * (ds.img_gt.ndim - 1)).astype(np.float32)
    out = {"input_param": ds.input_param,
           "imgs_u8": np.round(ds.img_gt / a * 255.0).astype(np.uint8),
           "bndry_dist": ds.bndry_dist.astype(np.uint16),
           "bndry_depth": ds.bndry_depth}
    if include_ny:
        out["ny_u8"] = np.round(ds.img_ny).astype(np.uint8)
        out["alpha"] = ds.alpha.astype(np.float32)
    return out


class StaticStep:
    """A training step on buffers of fixed address: the batch, the loss
    weights and every dropout mask the step draws.

    ``load(batch, gammas, seed)`` copies a step's inputs in and draws its
    masks, each by the seed the step's own forward draws it from
    (``draws(seed)``: (seed, shape) of each), with one generator reseeded
    for each draw, so each mask is the one ``keyed_dropout`` draws; the
    forward and a checkpointed layer's recompute read the same draw.
    ``run()`` runs the step (``body(batch, gammas, seed, masks)``) on the
    buffers; ``capture(stream)`` records ``run`` in a CUDA graph and
    ``replay()`` repeats it on the loaded inputs, returning a copy of the
    loss."""

    def __init__(self, body, draws, batch, gammas, mask_dtype):
        device = gammas.device
        self.body, self.draws, self.mask_dtype = body, draws, mask_dtype
        self.batch = {k: torch.empty(v.shape, dtype=v.dtype, device=device)
                      for k, v in batch.items()}
        self.gammas = torch.empty_like(gammas)
        self.generator = torch.Generator(device=device)
        self.buffers = None
        self.masks = self.seed = self.loss = self.graph = None

    def load(self, batch, gammas, seed: int) -> None:
        for k, v in batch.items():
            self.batch[k].copy_(v)
        self.gammas.copy_(gammas)
        sites = self.draws(seed)
        if self.buffers is None:
            self.buffers = [torch.empty(shape, dtype=self.mask_dtype, device=self.gammas.device)
                            for _, shape in sites]
        for (s, shape), buf in zip(sites, self.buffers):
            self.generator.manual_seed(s)
            torch.rand(shape, generator=self.generator, out=buf)
        self.masks = {s: buf for (s, _), buf in zip(sites, self.buffers)}
        self.seed = seed

    def run(self):
        self.loss = self.body(self.batch, self.gammas, self.seed, self.masks)
        return self.loss

    def capture(self, stream) -> None:
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=stream):
            self.run()

    def replay(self):
        self.graph.replay()
        return self.loss.clone()


def _signature(batch, gammas) -> tuple:
    return (tuple((k, tuple(v.shape), v.dtype, v.device) for k, v in sorted(batch.items())),
            tuple(gammas.shape), gammas.dtype, gammas.device)


class TrainStep:
    """``step(batch, gammas, seed)``: one optimizer step, returning the
    loss (``make_step_fns``).

    On a CUDA device, in one process (no collective) and with gradients on,
    the step runs as a CUDA graph, one for each input signature (the
    batch's keys, shapes and dtypes, and the loss weights'). The first call
    of a signature runs eagerly, on the stream the capture will use: it is
    a real step, and it warms up what a capture may not set up (the
    optimizer's state, cuBLAS's handles, autograd). The second loads its
    inputs into a ``StaticStep``, captures the step and replays it; every
    later call loads its inputs and replays the graph, in the span
    ``graph_replay``. A signature not yet captured runs eagerly while a
    profiler runs (spans record CUDA events, which a capture may not hold).
    Before the first such step the optimizer is made capturable
    (``optim.make_capturable``), so load a resumed optimizer state before
    it. Elsewhere, and in ``eager``, the step runs eagerly as written."""

    def __init__(self, body, draws, model: GlobalStage, optimizer, mesh: Mesh):
        self.body, self.draws, self.model = body, draws, model
        self.optimizer, self.mesh = optimizer, mesh
        self.steps: Dict[tuple, StaticStep] = {}
        self.stream = None

    def eager(self, batch, gammas, seed: int):
        """The step as written, run eagerly."""
        with span("train_step"), float32_precision():
            return self.body(batch, gammas, seed)

    def static(self, batch, gammas) -> StaticStep:
        """A new ``StaticStep`` for inputs of the signature of these."""
        B, _, L, _ = batch["input_param"].shape
        return StaticStep(self.body, functools.partial(self.draws, batch=B, tokens=L),
                          batch, gammas, self.model.compute_dtype)

    def __call__(self, batch, gammas, seed: int):
        device = next(self.model.parameters()).device
        if device.type != "cuda" or self.mesh.distributed or not torch.is_grad_enabled():
            return self.eager(batch, gammas, seed)
        with span("train_step"), float32_precision():
            key = _signature(batch, gammas)
            st = self.steps.get(key)
            if st is None or (st.graph is None and profiling()):
                if st is None:
                    make_capturable(self.optimizer)
                    if self.stream is None:
                        self.stream = torch.cuda.Stream(device)
                    self.steps[key] = self.static(batch, gammas)
                current = torch.cuda.current_stream(device)
                self.stream.wait_stream(current)
                with torch.cuda.stream(self.stream):
                    loss = self.body(batch, gammas, seed)
                current.wait_stream(self.stream)
                return loss
            if st.graph is None:
                st.load(batch, gammas, seed)
                # the capture's backward makes the gradients in its own pool
                self.optimizer.zero_grad(set_to_none=True)
                st.capture(self.stream)
                return st.replay()
            with span("graph_replay"):
                st.load(batch, gammas, seed)
                return st.replay()


def make_step_fns(model: GlobalStage, optimizer: torch.optim.Optimizer,
                  patch_cfg: PatchConfig, grid: GridConfig, dfd: DfDSolver,
                  grad_accum: int = 1, hard_mask: bool = False,
                  mesh: Optional[Mesh] = None):
    """(train_step, eval_step) of the JAX package's ``make_step_fns``.

    ``train_step(batch, gammas, seed)`` takes one AdamW step on the model's
    parameters (gradient clipped to a global norm of 1.0) and returns the
    loss; on a CUDA device in one process it runs as a CUDA graph
    (``TrainStep``). ``eval_step(batch, gammas)`` returns the loss without
    dropout. Batches are expanded or compact. Both run in full float32
    (TF32 off), the JAX package's ``default_matmul_precision("highest")``.

    The batch splits into ``grad_accum`` chunks with exact batch
    semantics: terms 1-6 are the mean of the chunks' means and the depth
    term is sum(S) / sum(N), so no chunk's gradient is known before every
    chunk's N is. With more than one chunk, each runs under activation
    checkpointing (the JAX package's checkpointed scan body), the losses
    are summed and one backward runs; a chunk's activations live only
    while its backward runs. Chunk i draws its dropout from
    fold_in(seed, i).

    Under a ``mesh`` of D ranks the batch is the rank's share of the global
    batch and ``grad_accum`` its chunks: rank r's chunk j is global chunk
    r * grad_accum + j and draws from fold_in(seed, r * grad_accum + j), so
    D ranks draw the masks one process draws for D * grad_accum chunks. N
    is all-reduced before the backward; the rank's loss is its chunks'
    mean terms plus D * gamma_depth * S_r / N, whose mean over the ranks,
    like the gradients' (averaged before the clip), is the global batch's.
    Both steps return that global loss.
    """
    mesh = mesh or make_mesh()
    params = [p for p in model.parameters() if p.requires_grad]
    chunks = max(grad_accum, 1)

    def chunk_seed(seed, i):
        return fold_in(seed, mesh.rank * chunks + i)

    def loss_parts(batch, seed, train, masks):
        est = model(tokens_from_params_src(batch["input_param"]), train=train,
                    seed=seed, masks=masks)
        img_colors = batch["img_gt"] if train else batch["img_ny"]
        with span("loss"):
            return global_loss_terms(est, img_colors, batch["img_gt"], batch["bndry_dist"],
                                     batch["deri"], batch["bndry_depth"], patch_cfg,
                                     grid, dfd, hard_mask=hard_mask)

    def loss_fn(batch, gammas, seed, train, masks=None):
        batch = expand_compact_batch(batch)
        B = batch["input_param"].shape[0]
        if B % chunks:
            raise ValueError(f"batch {B} does not split into {chunks} chunks")
        c = B // chunks
        # no draw uses the global generator, whose state a CUDA graph's
        # capture may not read
        part = (functools.partial(checkpoint, loss_parts, use_reentrant=False,
                                  preserve_rng_state=False)
                if torch.is_grad_enabled() and chunks > 1 else loss_parts)
        t_sum = S = N = 0.0
        for i in range(chunks):
            chunk = {k: v[i * c:(i + 1) * c] for k, v in batch.items()}
            terms, S_i, N_i = part(chunk, chunk_seed(seed, i), train, masks)
            t_sum, S, N = t_sum + terms, S + S_i, N + N_i
        N = all_reduce(N.detach().clone(), mesh)
        return (gammas[:6] * (t_sum / chunks)).sum() + gammas[6] * (mesh.size * S) / N

    def dropout_draws(seed, batch, tokens):
        """(seed, shape) of every dropout mask of a step on ``batch``
        samples of ``tokens`` tokens."""
        return [d for i in range(chunks)
                for d in model.dropout_draws(chunk_seed(seed, i), batch // chunks, tokens)]

    def global_mean(loss):
        return all_reduce(loss.detach().clone(), mesh) / mesh.size

    def step_body(batch, gammas, seed, masks=None):
        # reference quirk: colors solved on the clean images in training (:210)
        loss = loss_fn(batch, gammas, seed, True, masks)
        optimizer.zero_grad(set_to_none=True)
        with span("backward"):
            loss.backward()
        with span("optimizer"):
            mean_gradients(params, mesh)
            clip_by_global_norm_(params, 1.0)
            optimizer.step()
        return global_mean(loss)

    def eval_step(batch, gammas):
        with float32_precision(), torch.no_grad():
            return global_mean(loss_fn(batch, gammas, 0, False))

    return TrainStep(step_body, dropout_draws, model, optimizer, mesh), eval_step


def load_global_compact(data_path: str, train: bool, subset: int = 0,
                        include_ny: bool = False) -> Dict[str, np.ndarray]:
    """The compact arrays of a split, read through mmap: only what the
    compact form needs (the derivative maps are recomputed from the uint8
    images), converted to uint8 in chunks of 1,000 samples; the float32
    tokens are left memory-mapped (a view, no copy)."""
    part = "train" if train else "val"

    def mm(name):
        return np.load(f"{data_path}/{name}_{part}.npy", mmap_mode="r")

    n_total = mm("alphas").shape[0]
    n = min(subset, n_total) if subset else n_total
    alpha = np.asarray(mm("alphas")[:n]).astype(np.float32)

    def to_u8(name, scale_by_alpha):
        src = mm(name)
        out = np.empty((n,) + src.shape[1:], np.uint8)
        for s in range(0, n, 1000):
            e = min(n, s + 1000)
            chunk = np.asarray(src[s:e], dtype=np.float32)
            if scale_by_alpha:
                a = alpha[s:e].reshape((-1,) + (1,) * (src.ndim - 1))
                chunk = chunk / a * 255.0
            out[s:e] = np.round(chunk).astype(np.uint8)
        return out

    # the tokens stay memory-mapped: to_device_batch reads them in chunks
    out = {"input_param": np.asarray(mm("params_src")[:n], dtype=np.float32),
           "imgs_u8": to_u8("images_gt", scale_by_alpha=True),
           "bndry_dist": np.asarray(mm("boundary_distances")[:n]).astype(np.uint16),
           "bndry_depth": np.asarray(mm("boundary_depths")[:n], dtype=np.float32)}
    if include_ny:
        out["ny_u8"] = to_u8("images_ny", scale_by_alpha=False)
        out["alpha"] = alpha
    return out


# samples of float32 tokens a host-to-device copy carries before the cast
TOKEN_CAST_CHUNK = 256


def to_device_batch(arrays: Dict[str, np.ndarray], device, bf16_tokens=False):
    """Compact numpy arrays -> tensors on ``device``. uint16 distances go
    to int32 (exact; torch's uint16 support is partial); the tokens rest in
    bfloat16 when ``bf16_tokens`` (the JAX package's resident train set),
    cast on the device ``TOKEN_CAST_CHUNK`` samples at a time, so the host
    never holds a second copy of them (5 GB in float32 at 8,000 samples)."""
    out = {}
    for k, v in arrays.items():
        if k == "input_param" and bf16_tokens:
            t = torch.empty(v.shape, dtype=torch.bfloat16, device=device)
            for s in range(0, len(v), TOKEN_CAST_CHUNK):
                part = np.array(v[s:s + TOKEN_CAST_CHUNK], dtype=np.float32)
                t[s:s + TOKEN_CAST_CHUNK] = torch.from_numpy(part).to(device).to(torch.bfloat16)
            out[k] = t
            continue
        t = torch.from_numpy(np.array(v, dtype=np.int32 if v.dtype == np.uint16 else v.dtype))
        out[k] = t.to(device)
    return out


def init_state(model: GlobalStage, seed: int, lr: float) -> torch.optim.AdamW:
    """Re-initialise ``model`` as the JAX package's ``init_state`` does
    (Xavier normal, seeded) and return its optimizer."""
    xavier_reinit(model, torch.Generator().manual_seed(seed))
    return make_optimizer(model.parameters(), lr)


def gamma_ranges_from_args(args) -> Dict[str, tuple]:
    return {"color": tuple(args.gamma_color),
            "color_cons": tuple(args.gamma_color_cons),
            "bndry_cons": tuple(args.gamma_bndry_cons),
            "smthns": tuple(args.gamma_smthns),
            "smthns_cons": tuple(args.gamma_smthns_cons),
            "bndry_loc": tuple(args.gamma_bndry_loc),
            "depth": tuple(args.gamma_depth)}


def run_global_training(args, snapshot_every: int = None, resume: bool = True,
                        device="cuda", mesh: Optional[Mesh] = None) -> None:
    """The global-stage trainer's harness (reference global_training.py:
    173-225, with the JAX package's additions): the compact train set
    resident on the device (uint8 images, bf16 tokens); one optimizer step a
    call with a per-step heartbeat in ``<log_path>/global_steps.log``; a
    step snapshot every ``snapshot_every`` steps (None: ``--snapshot_steps``)
    and at every epoch's end, resumed mid-epoch (the shuffle is derived from
    the epoch); ``--time_budget_s`` exits cleanly with a snapshot;
    ``--skip_val`` / ``--val_batches`` bound the validation sweep. Writes
    ``best_run_<exp>.pth`` (the model's state dict) and
    ``last_<exp>.pth`` (the snapshot) under ``--model_path``.

    A batch splits into chunks of ``CHUNK_SAMPLES`` samples (the JAX
    package's gradient accumulation at the full 64x64 grid; chunks of one
    for an odd batch), each drawing its dropout by its index in the batch,
    at every grid and every D. ``mesh`` (``parallel.make_mesh`` inside a
    rank; the JAX package's ``mesh``): each rank keeps its contiguous
    share of the train set resident, every rank derives the same shuffle,
    the global batch's rows are put together from the shares that hold
    them (``gather_rows``) and each rank steps on its share of it, its
    share of the chunks (``make_step_fns``), so D ranks draw the masks one
    process draws; each rank reads its share of every validation batch;
    the time budget's stop is taken together; rank 0 writes the
    checkpoints, snapshots, logs and curve.
    """
    from ..config import cam_from_args, grid_from_args, patch_from_args
    from ..data.datasets import BatchIterator
    from ..parallel.mesh import (any_rank, barrier, data_sharding, gather_rows, replicate,
                                 shard_batch)
    from ..utils.io import TrainLogger, create_directory, show_curve
    from ..utils.seeding import set_seed
    from . import schedules
    from .checkpoint import load_checkpoint, save_checkpoint
    from .resume import load_step_snapshot, save_step_snapshot

    device = resolve_device(device)
    mesh = mesh or make_mesh(getattr(args, "dp_devices", 0), device=device)
    root_seed = set_seed(1898)
    if mesh.is_main:
        create_directory(args.log_path, overwrite=False)
    barrier(mesh)
    patch_cfg = patch_from_args(args)
    grid = grid_from_args(args)
    dfd = DfDSolver.from_config(cam_from_args(args), patch_cfg)
    if snapshot_every is None:
        snapshot_every = getattr(args, "snapshot_steps", 50)
    time_budget = getattr(args, "time_budget_s", 0)
    skip_val = getattr(args, "skip_val", False)
    val_batches = getattr(args, "val_batches", 0) or None
    w_variant = getattr(args, "w_variant", False)
    exp = "exp_global_stage_w" if w_variant else "exp_global_stage"
    t_start = time.time()

    def say(msg):
        if mesh.is_main:
            print(f"[global +{time.time() - t_start:7.1f}s] {msg}", flush=True)

    subset = getattr(args, "train_subset", 0)
    compact_train = load_global_compact(args.data_path, train=True, subset=subset)
    compact_val = load_global_compact(args.data_path, train=False, include_ny=True)
    n_train = compact_train["input_param"].shape[0]
    n_val = compact_val["input_param"].shape[0]
    say(f"data loaded: {n_train} train ({'subset' if subset else 'full'}), "
        f"{n_val} val, compact "
        f"{sum(v.nbytes for v in compact_train.values()) / 1e9:.2f} GB train")

    t0 = time.time()
    data_train = to_device_batch(shard_batch(compact_train, mesh), device, bf16_tokens=True)
    start = data_sharding(n_train, mesh).start
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    say(f"train set resident on {device} ({time.time() - t0:.1f}s transfer"
        + (f", a share on each of {mesh.size} ranks)" if mesh.size > 1 else ")"))
    del compact_train

    model = GlobalStage(in_parameter_size=args.input_size,
                        out_parameter_size=args.output_size,
                        attn_impl=getattr(args, "attn_impl", "xla")).to(device)
    optimizer = init_state(model, root_seed, args.learning_rate)
    init_from = getattr(args, "init_from", None)
    if init_from:
        # warm start; optimizer and scheduler state start fresh
        model.load_state_dict(load_checkpoint(init_from))
        say(f"model warm-started from {init_from}")
    replicate(model, mesh)
    n_chunks = args.batch_size // math.gcd(args.batch_size, CHUNK_SAMPLES)
    if n_chunks % mesh.size:
        raise ValueError(f"batch {args.batch_size} in {n_chunks} chunks does not split "
                         f"over {mesh.size} ranks")
    chunks = n_chunks // mesh.size       # a rank's
    share = data_sharding(args.batch_size, mesh)
    train_step, eval_step = make_step_fns(model, optimizer, patch_cfg, grid, dfd, chunks,
                                          hard_mask=w_variant, mesh=mesh)

    def eval_sweep(gammas, max_batches=None):
        nb = n_val // args.batch_size
        if max_batches:
            nb = min(nb, max_batches)
        total = 0.0
        for b in range(nb):
            sl = slice(b * args.batch_size + share.start, b * args.batch_size + share.stop)
            batch = to_device_batch({k: v[sl] for k, v in compact_val.items()}, device)
            total += float(eval_step(batch, gammas))
        return total / max(nb, 1)

    sched = schedules.PlateauScheduler(lr=args.learning_rate, factor=0.975,
                                       patience=5, min_lr=args.learning_rate * 0.5)
    ranges = gamma_ranges_from_args(args)
    final_g = gammas_to_array(schedules.final_gamma(ranges), device)
    nb_train = n_train // args.batch_size

    best_loss, best_epoch = np.inf, 0
    start_epoch, start_step, loss_sum, loss_count = 0, 0, 0.0, 0
    snap_path = f"{args.model_path}/last_{exp}"
    curve_path = f"{args.log_path}/loss_curve_{exp}.npy"
    curve = np.zeros((args.epoch_num,), dtype=float)
    if os.path.exists(curve_path):
        prev = np.load(curve_path)
        curve[:min(len(prev), len(curve))] = prev[:len(curve)]
    resumed = False
    if resume:
        snap = load_step_snapshot(snap_path, model, optimizer)
        if snap is not None:
            sched, mid = snap
            start_epoch, start_step = mid["epoch"], mid["step"]
            loss_sum, loss_count = mid["loss_sum"], mid["loss_count"]
            best_loss, best_epoch = mid["best_loss"], mid["best_epoch"]
            resumed = True
            say(f"RESUMED at epoch {start_epoch} step {start_step} "
                f"(best {best_loss:.6f} @ {best_epoch})")

    logger = (TrainLogger(f"{args.log_path}/{exp}_training.txt", args, append=resumed)
              if mesh.is_main else None)
    steplog = open(f"{args.log_path}/global_steps.log", "a") if mesh.is_main else None
    if skip_val:
        say("NOTE: --skip_val: loss curve / best-checkpoint selection uses the "
            "mean TRAIN loss (deviation from reference best-VAL semantics, "
            "global_training.py:216-219)")

    def take_snapshot(epoch, step):
        if mesh.is_main:
            save_step_snapshot(snap_path, model, optimizer, sched, epoch=epoch, step=step,
                               loss_sum=loss_sum, loss_count=loss_count,
                               best_loss=best_loss, best_epoch=best_epoch)

    stop = False
    for epoch in range(start_epoch, args.epoch_num):
        gammas = gammas_to_array(
            schedules.gamma_schedule(epoch, args.dynamic_epoch, ranges), device)
        batches = list(BatchIterator(n_train, args.batch_size, shuffle=True,
                                     seed=1898 + 7919 * epoch))
        first = start_step if epoch == start_epoch else 0
        for b in range(first, nb_train):
            batch = {k: v[share] for k, v in
                     gather_rows(data_train, start, batches[b], mesh).items()}
            t0 = time.time()
            loss = train_step(batch, gammas, fold_in(fold_in(root_seed, epoch), b))
            loss = float(loss)  # a sync: the heartbeat's time is the step's
            dt = time.time() - t0
            loss_sum += loss
            loss_count += 1
            if steplog is not None:
                steplog.write(f"{epoch:4d} {b:5d} {loss:.6f} {dt:7.3f}s\n")
                steplog.flush()
            if b == first or (b + 1) % 25 == 0:
                say(f"epoch {epoch} step {b + 1}/{nb_train} "
                    f"loss {loss:.5f} ({dt:.2f}s/step)")
            if snapshot_every and (b + 1) % snapshot_every == 0:
                take_snapshot(epoch, b + 1)
            if time_budget and any_rank(time.time() - t_start > time_budget, mesh):
                say(f"time budget {time_budget}s reached at epoch {epoch} "
                    f"step {b + 1}; snapshotting and exiting cleanly")
                take_snapshot(epoch, b + 1)
                if mesh.is_main:
                    np.save(curve_path, curve)
                stop = True
                break
        if stop:
            break
        tr_loss = loss_sum / max(loss_count, 1)
        loss_sum, loss_count = 0.0, 0
        if skip_val:
            curve[epoch] = tr_loss
        else:
            t0 = time.time()
            curve[epoch] = eval_sweep(final_g, val_batches)
            say(f"epoch {epoch} train {tr_loss:.6f} val {curve[epoch]:.6f} "
                f"({time.time() - t0:.1f}s val sweep)")
        if mesh.is_main:
            logger.epoch(epoch, curve[epoch], sched.patience, sched.lr)
        if curve[epoch] < best_loss:
            best_loss, best_epoch = curve[epoch], epoch
            if mesh.is_main:
                save_checkpoint(f"{args.model_path}/best_run_{exp}", model.state_dict())
        # the LR scheduler steps only once the second schedule phase begins
        # (reference global_training.py:220-221)
        if epoch >= args.dynamic_epoch[1]:
            set_lr(optimizer, sched.step(curve[epoch]))
        take_snapshot(epoch + 1, 0)
        if mesh.is_main:
            np.save(curve_path, curve)
        barrier(mesh)

    if mesh.is_main:
        steplog.close()
        if not stop:
            np.save(curve_path, curve)
            show_curve(args.log_path, curve, f"loss_curve_{exp}")
            logger.footer(best_epoch, best_loss)
            # completion marker for supervisor retry loops
            done = "done_global_w" if w_variant else "done_global"
            with open(f"{args.model_path}/{done}", "w") as f:
                f.write(f"best {best_loss:.8f} @ epoch {best_epoch}\n")
        logger.close()
    barrier(mesh)
