"""The global trainer's step in plain PyTorch, float32: the global stage's
training forward, the seven loss terms on the patch grid
(guo-research-group/Blurry-Edges ``global_training.py:93-157``), autograd's
backward, the clip of the global gradient norm at 1.0 and the AdamW update
(betas 0.9 / 0.999, eps 1e-8, decoupled weight decay 1e-4), written out.

The batch splits into chunks of ``chunk`` samples as the program's trainer
splits it: terms 1-6 are the mean of the chunks' means and the depth term
is sum(S) / sum(N); chunk i of a step with seed s draws its dropout from
fold_in(s, i). The benchmark's frozen copy; it imports nothing of the
program."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import wedge as W
from .keying import fold_in

BETAS, EPS, WEIGHT_DECAY, CLIP = (0.9, 0.999), 1e-8, 1e-4, 1.0
_SX = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))
_SY = ((1.0, 2.0, 1.0), (0.0, 0.0, 0.0), (-1.0, -2.0, -1.0))


def sobel(img, eps: float = 1e-8):
    """Valid-mode Sobel magnitude per channel: (..., H, W, C) -> (..., H-2, W-2, C)."""
    lead, (H, Wd, C) = img.shape[:-3], img.shape[-3:]
    x = img.reshape(-1, H, Wd, C).permute(0, 3, 1, 2).reshape(-1, 1, H, Wd)
    k = torch.tensor((_SX, _SY), dtype=img.dtype, device=img.device)[:, None]
    g = F.conv2d(x, k)
    out = torch.sqrt(g[:, 0] ** 2 + g[:, 1] ** 2 + eps).reshape(-1, C, H - 2, Wd - 2)
    return out.permute(0, 2, 3, 1).reshape(lead + (H - 2, Wd - 2, C))


def sobel_patches(p, R: int, eps: float = 1e-8):
    """The Sobel magnitude of flat R x R patches: (..., R*R) -> (..., (R-2)^2)."""
    img = p.reshape(-1, R, R)[..., None]
    return sobel(img, eps)[..., 0].reshape(p.shape[:-1] + ((R - 2) ** 2,))


def flat_patches(img, r: int, stride: int):
    """(n, H, W) -> (n, L, r*r), patch (i, j) at row i * Wp + j."""
    return F.unfold(img[:, None], r, stride=stride).transpose(1, 2)


def fold_flat(p, H: int, Wd: int, R: int, stride: int):
    """(n, L, R*R) -> (n, H, W) overlap-add."""
    return F.fold(p.transpose(1, 2), (H, Wd), R, stride=stride)[:, 0]


def loss_terms(est, img_colors, img_gt, bdist, deri, bdepth, cfg: dict, dfd: W.DfD):
    """est (B, L, 12); images (B, 2, H, W, 3); bdist, bdepth (B, H, W);
    deri (B, 2, H-2, W-2, 3) -> (six batch-mean terms, depth S, depth N)."""
    R, w, lam, stride = cfg["R"], cfg["w"], cfg["lambda_ridge"], cfg["stride"]
    B, L = est.shape[:2]
    H, Wd = img_gt.shape[2:4]
    n = R * R
    xy = est[..., :4] * 3.0
    ang = torch.remainder((est[..., 4:8] + 1.0) * W.PI, W.TWO_PI)
    etas = W.etas_of(est[..., 8:] + 0.5)                              # (B, L, 4)
    x, y = W.pixel_coords(R, est.dtype, est.device)
    d1, d2 = W.wedge_dists(torch.cat([xy, ang], -1), x, y, w)         # (B, L, n)
    U = torch.stack([W.memberships(d1, d2, etas[..., 0], etas[..., 1]),
                     W.memberships(d1, d2, etas[..., 2], etas[..., 3])])  # (2, B, L, 3, n)

    def patches_of(imgs, r):                                           # (B, 2, h, w, 3) -> (2, B, L, 3, r*r)
        b, _, h, wd, c = imgs.shape
        f = flat_patches(imgs.permute(1, 0, 4, 2, 3).reshape(-1, h, wd), r, stride)
        return f.reshape(2, b, c, L, r * r).transpose(2, 3)

    Y = patches_of(img_colors, R)
    colors = W.ridge_colors(torch.cat([U[0], U[1]], -1), torch.cat([Y[0], Y[1]], -1), lam)
    rend = (U[..., :, None, :] * colors[None, ..., :, :, None]).sum(-3)   # (2, B, L, 3, n)
    bndry = W.bump(torch.where(d2 >= 0, d2, torch.where(d1.abs() < d2.abs(), d1.abs(), d2.abs())))
    dep1 = dfd.depth(etas[..., 0], etas[..., 2])
    dep2 = dfd.depth(etas[..., 1], etas[..., 3])
    mask = W.depth_mask(d1, d2, False)
    depth = torch.where(mask == 1, dep1[..., None], torch.where(mask == 2, dep2[..., None], 0.0))

    count = fold_flat(torch.ones((1, L, n), dtype=est.dtype, device=est.device), H, Wd, R, stride)[0]
    gimg = fold_flat(rend.detach().transpose(2, 3).reshape(-1, L, n), H, Wd, R, stride)
    gimg = gimg.reshape(2, B, 3, H, Wd) / count
    gimg = gimg.permute(1, 0, 3, 4, 2)                                # (B, 2, H, W, 3)
    gbnd = fold_flat(bndry.detach(), H, Wd, R, stride) / count        # (B, H, W)

    t_color = ((patches_of(img_gt, R) - rend) ** 2).sum(-2).mean()
    t_color_cons = ((rend - patches_of(gimg, R)) ** 2).sum(-2).mean()
    t_bndry_cons = ((bndry - flat_patches(gbnd, R, stride)) ** 2).mean()
    rd = sobel_patches(rend, R)                                       # (2, B, L, 3, (R-2)^2)
    t_smthns = ((rd - patches_of(deri, R - 2)) ** 2).sum(-2).mean()
    t_smthns_cons = ((rd - patches_of(sobel(gimg), R - 2)) ** 2).sum(-2).mean()
    bd = flat_patches(torch.log2(bdist + 1.0), R, stride)
    t_bndry_loc = ((bd * bndry) ** 2).mean()
    bdep = flat_patches(bdepth, R, stride)
    m = torch.where(bdep == 0, 0.0, torch.where(mask == 0, 0.0, 1.0))
    S = (((depth - bdep) * m) ** 2).sum()
    return torch.stack([t_color, t_color_cons, t_bndry_cons, t_smthns, t_smthns_cons,
                        t_bndry_loc]), S, m.sum()


def expand(batch: dict) -> dict:
    """The compact training batch (uint8 clean images, bf16 tokens, integer
    boundary distances) -> the loss inputs in float32."""
    img = batch["imgs_u8"].float() / 255.0
    B, _, H, Wd, _ = img.shape
    return dict(tokens=batch["input_param"].float().transpose(1, 2).reshape(B, -1, 38),
                img=img, deri=sobel(img), bdist=batch["bndry_dist"].float(),
                bdepth=batch["bndry_depth"].float())


def loss_backward(model, batch: dict, gammas, seed: int, chunk: int, cfg: dict, dfd: W.DfD):
    """The step's loss with dropout keyed from ``seed``, chunk by chunk, its
    gradient accumulated into the parameters' ``.grad``. The depth term's
    count N over the whole batch is known first (a forward without
    gradients), so each chunk's backward runs before the next chunk's
    forward and only one chunk's graph is held."""
    e = expand(batch)
    B = e["tokens"].shape[0]
    parts = [{k: v[s:s + chunk] for k, v in e.items()} for s in range(0, B, chunk)]

    def terms(i, part):
        est = model(part["tokens"], seed=fold_in(seed, i))
        return loss_terms(est, part["img"], part["img"], part["bdist"], part["deri"],
                          part["bdepth"], cfg, dfd)

    with torch.no_grad():
        N = sum(terms(i, p)[2] for i, p in enumerate(parts))
    total = 0.0
    for i, part in enumerate(parts):
        t, S, _ = terms(i, part)
        val = (gammas[:6] * t).sum() / len(parts) + gammas[6] * S / N
        val.backward()
        total += float(val.detach())
    return total


@torch.no_grad()
def adamw(params, grads, m, v, t: int, lr: float):
    """One AdamW step in place (decoupled decay first, bias-corrected moments)."""
    b1, b2 = BETAS
    for p, g, mi, vi in zip(params, grads, m, v):
        p.mul_(1.0 - lr * WEIGHT_DECAY)
        mi.mul_(b1).add_(g, alpha=1.0 - b1)
        vi.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        denom = (vi.sqrt() / np.sqrt(1.0 - b2 ** t)).add_(EPS)
        p.addcdiv_(mi, denom, value=-lr / (1.0 - b1 ** t))


def steps(model, batches, gammas, seeds, chunk: int, lr: float, cfg: dict, dfd: W.DfD):
    """The trainer's first steps from ``model``'s weights: each step's loss,
    the clipped first gradient of every parameter (what the optimizer got)
    and the parameters after the last step, both by parameter name."""
    names, params = zip(*model.named_parameters())
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    losses, first = [], None
    for t, (batch, seed) in enumerate(zip(batches, seeds), start=1):
        model.zero_grad(set_to_none=True)
        val = loss_backward(model, batch, gammas, seed, chunk, cfg, dfd)
        grads = [p.grad.detach() for p in params]
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        scale = torch.where(norm < CLIP, torch.ones_like(norm), CLIP / norm)
        grads = [g * scale for g in grads]
        if first is None:
            first = [g.clone() for g in grads]
        adamw(params, grads, m, v, t, lr)
        losses.append(val)
    return losses, dict(zip(names, first)), {k: p.detach().clone() for k, p in zip(names, params)}
