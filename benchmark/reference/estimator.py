"""The Blurry-Edges estimator in plain PyTorch, float32 (guo-research-group/
Blurry-Edges ``blurry_edges_test.py:117-145``, and
``blurry_edges_test_big.py:116-183`` for the block-tiled large images):
unfold, the local CNN, the per-patch colors, the 19 token features, the
global stage, denormalisation and blur levels, the render, the fold and the
densify (the depth-completion U-Net, or a threshold on the confidence).

The benchmark's frozen copy; it imports nothing of the program. It runs
``group`` patch grids through the networks in one call (pairs of a batched
request, or blocks of a large image), as the caller says the program
batches them: a float32 convolution's rounding depends on the batch it
runs in (the library picks its algorithm by shape), and this model
amplifies a float32-level change of a wedge into knife-edge flips, so the
reference keeps the program's batching and judges the arithmetic."""

from __future__ import annotations

import math

import torch

from . import wedge as W


class Estimator:
    """``nets``: the reference networks ('local', 'global', optionally
    'unet') on one device; ``cfg``: the configuration's geometry; ``group``:
    grids a network call takes. TF32 is off for the networks' products
    unless ``tf32`` (the control)."""

    def __init__(self, nets: dict, cfg: dict, group: int = 1, tf32: bool = False):
        self.nets, self.cfg, self.group, self.tf32 = nets, cfg, group, tf32
        self.dfd = W.DfD(cfg["cam"], cfg["R"], cfg["mag"])

    def _precision(self):
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = self.tf32

    def _renders(self, grids, hard: bool) -> list:
        """(G, 2, h, w, 3) blocks or images -> the render of each one's
        patch grid, the G grids through each network in one call."""
        c = self.cfg
        R, stride = c["R"], c["stride"]
        G = grids.shape[0]
        patches = W.unfold(grids.reshape((2 * G,) + grids.shape[2:]), R, stride)
        Hp, Wp = patches.shape[1:3]
        L = Hp * Wp
        flat = patches.reshape(-1, R, R, 3)
        params = W.wrap_angles(self.nets["local"](flat))
        colors = W.patch_colors(params, flat, R, c["w"], c["lambda_ridge"])
        tok = W.tokens(params, colors).reshape(G, 2, L, 19).transpose(1, 2).reshape(G, L, 38)
        est = self.nets["global"](tok)
        xy = est[..., :4] * 3.0
        ang = torch.remainder((est[..., 4:8] + 1.0) * W.PI, W.TWO_PI)
        etas = W.etas_of(est[..., 8:] + 0.5)
        geo = torch.cat([xy, ang], -1).reshape(G, Hp, Wp, 8)
        img = patches.reshape((G, 2) + patches.shape[1:])
        return [W.render(geo[g], etas[g].reshape(Hp, Wp, 4), img[g], R, c["w"],
                         c["lambda_ridge"], self.dfd, c["rho_prime"], hard) for g in range(G)]

    @torch.no_grad()
    def densify(self, global_depth, confidence):
        """The served depth (H, W) from the folded depth and confidence: the
        U-Net for ``pp``, else the confidence threshold."""
        c = self.cfg
        self._precision()
        if c["densify"] == "pp":
            return self.nets["unet"](global_depth[None, None])[0, 0]
        thres = 0.0 if c["densify"] == "w" else c["depth_thres"]
        return torch.where(confidence > thres, global_depth, 0.0)

    def _answer(self, maps):
        return dict(depth_final=self.densify(maps["global_depth"], maps["confidence"]),
                    confidence=maps["confidence"], global_depth=maps["global_depth"])

    @torch.no_grad()
    def __call__(self, pairs) -> list:
        """(B, 2, H, W, 3) alpha-normalised pairs -> for each, depth_final,
        confidence and global_depth (H, W)."""
        c = self.cfg
        self._precision()
        H, Wd = pairs.shape[2:4]
        if "block" in c:
            return [self._answer(W.fold_maps(self._stitched(p), H, Wd, c["stride"]))
                    for p in pairs]
        return [self._answer(W.fold_maps(rend, H, Wd, c["stride"]))
                for g in range(0, len(pairs), self.group)
                for rend in self._renders(pairs[g:g + self.group], c["densify"] == "w")]

    def _stitched(self, pair):
        """The reference's loop over blocks, ``group`` blocks a network call
        in row-major order: each block's patch grid, its margins dropped
        where a neighbour covers them, written into the large image's patch
        grid."""
        c = self.cfg
        R, stride, m, b = c["R"], c["stride"], c["n_margin_patch"], c["block"]
        H = pair.shape[1]
        bstride = b - R + stride - 2 * stride * m
        nb = math.ceil((H - R - 2 * stride * m + stride) / bstride)
        hp_b = (b - R) // stride + 1
        keep = hp_b - 2 * m
        hp = (H - R) // stride + 1
        blocks = [(i, j) for i in range(nb) for j in range(nb)]
        big = None
        for g in range(0, len(blocks), self.group):
            ids = blocks[g:g + self.group]
            grids = torch.stack([pair[:, i * bstride:i * bstride + b, j * bstride:j * bstride + b]
                                 for i, j in ids])
            for (i, j), rend in zip(ids, self._renders(grids, False)):
                if big is None:
                    big = {k: v.new_zeros(((2,) if k == "patches" else ())
                                          + (hp, hp) + v.shape[(3 if k == "patches" else 2):])
                           for k, v in rend.items()}
                (I0, I1, i0, i1), (J0, J1, j0, j1) = (_span(i, nb, keep, m, hp_b),
                                                      _span(j, nb, keep, m, hp_b))
                for k, v in rend.items():
                    if k == "patches":
                        big[k][:, I0:I1, J0:J1] = v[:, i0:i1, j0:j1]
                    else:
                        big[k][I0:I1, J0:J1] = v[i0:i1, j0:j1]
        return big


def _span(i: int, n: int, keep: int, m: int, hp_b: int):
    """Block row (or column) i of n: the large grid's rows it writes and the
    block's rows they come from (blurry_edges_test_big.py:166-183); the
    first and last blocks keep their outer margins."""
    first, last = int(i == 0), int(i == n - 1)
    return (i * keep + (1 - first) * m, (i + 1) * keep + (1 + last) * m,
            (1 - first) * m, (last - 1) * m + hp_b)
