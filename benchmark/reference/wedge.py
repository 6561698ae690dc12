"""The Blurry-Edges patch model in plain PyTorch, float32: two wedges a
patch (corner, base angle, opening, a blur level for each image), their
signed distance fields, soft memberships, the per-patch ridge colors with
a Cayley-Hamilton 3x3 inverse, the boundary map, the analytic
depth-from-defocus, and unfold / fold of patch grids (guo-research-group/
Blurry-Edges, ``utils/postprocessing_loss.py``, ``utils/depth_etas.py``,
``blurry_edges_test.py``). The benchmark's frozen copy of the plain
versions the program's kernels are held to; it imports nothing of the
program."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

PI, TWO_PI = math.pi, 2.0 * math.pi


# ---------------------------------------------------------------- geometry

def pixel_coords(R: int, dtype, device):
    """Flat (x, y) of an R x R patch's pixels, both in [-1, 1], row-major."""
    c = torch.linspace(-1.0, 1.0, R, dtype=dtype, device=device)
    y, x = torch.meshgrid(c, c, indexing="ij")
    return x.reshape(-1), y.reshape(-1)


def _soft(d_edge, d_axial, w):
    sgn = torch.where(d_edge < 0, -1.0, 1.0)
    return torch.where(d_axial < 0, torch.sqrt(d_edge ** 2 + (d_axial * w) ** 2) * sgn, d_edge)


def wedge_dists(p, x, y, w: float):
    """p (..., 8) = (x0, y0, x1, y1, th1, ph1, th2, ph2); x, y (N,) ->
    the signed distances (d1, d2) of the two wedges, each (..., N)."""
    q = [p[..., i, None] for i in range(8)]
    x0, y0, x1, y1, th1, ph1, th2, ph2 = q

    def edge(cx, cy, a):
        return _soft(-torch.sin(a) * (x - cx) + torch.cos(a) * (y - cy),
                     torch.cos(a) * (x - cx) + torch.sin(a) * (y - cy), w)

    s1 = torch.where(torch.remainder(ph1, TWO_PI) < PI, 1.0, -1.0)
    s2 = torch.where(torch.remainder(ph2, TWO_PI) < PI, 1.0, -1.0)
    d11, d12 = edge(x0, y0, th1), edge(x0, y0, th1 + ph1)
    d21, d22 = edge(x1, y1, th2), edge(x1, y1, th2 + ph2)
    ind1 = s1 * torch.where((s1 * d11 > 0) & (s1 * d12 < 0), 1.0, -1.0)
    ind2 = s2 * torch.where((s2 * d21 >= 0) & (s2 * d22 <= 0), 1.0, -1.0)
    return (torch.minimum(d11.abs(), d12.abs()) * ind1,
            torch.minimum(d21.abs(), d22.abs()) * ind2)


def etas_of(coefs):
    """Blur level 10^(2 erf(c) - 2)."""
    return 10.0 ** (torch.erf(coefs) * 2.0 - 2.0)


def step(d, eta):
    return 0.5 * (1.0 + torch.erf(d / (math.sqrt(2.0) * eta[..., None])))


def memberships(d1, d2, e1, e2):
    """(u0, u1, u2) stacked on axis -2: (..., 3, N)."""
    h1, h2 = step(d1, e1), step(d2, e2)
    return torch.stack([(1.0 - h1) * (1.0 - h2), h1 * (1.0 - h2), h2], dim=-2)


def inverse_3x3(A):
    """Cayley-Hamilton inverse in float64, returned in A's dtype."""
    dtype, A = A.dtype, A.double()

    def mm(a, b):
        return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)

    A2 = mm(A, A)
    t1 = A.diagonal(dim1=-2, dim2=-1).sum(-1)
    t2 = A2.diagonal(dim1=-2, dim2=-1).sum(-1)
    t3 = mm(A2, A).diagonal(dim1=-2, dim2=-1).sum(-1)
    det = (t1 ** 3 - 3.0 * t1 * t2 + 2.0 * t3) / 6.0
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    adj = A2 - t1[..., None, None] * A + ((t1 ** 2 - t2) / 2.0)[..., None, None] * eye
    return (adj / det[..., None, None]).to(dtype)


def ridge_colors(U, Y, lam: float):
    """Memberships U (..., 3, N) and pixels Y (..., 3 channels, N) ->
    colors (..., 3 wedges, 3 channels) = (U U^T + lam I)^-1 U Y^T."""
    gram = (U[..., :, None, :] * U[..., None, :, :]).sum(-1)
    uy = (U[..., :, None, :] * Y[..., None, :, :]).sum(-1)
    inv = inverse_3x3(gram + lam * torch.eye(3, dtype=U.dtype, device=U.device))
    return (inv[..., :, :, None] * uy[..., None, :, :]).sum(-2)


def wrap_angles(p):
    """Raw local-stage outputs (..., 10) with the four angles taken mod 2 pi."""
    return torch.cat([p[..., :4], torch.remainder(p[..., 4:8], TWO_PI), p[..., 8:]], -1)


def patch_colors(params, pixels, R: int, w: float, lam: float):
    """The local stage's per-patch solve: raw params (P, 10), pixels
    (P, R, R, 3) -> colors (P, 3, 3) (the program's wedge_colors kernel)."""
    p = wrap_angles(params)
    x, y = pixel_coords(R, p.dtype, p.device)
    d1, d2 = wedge_dists(p[:, :8], x, y, w)
    e = etas_of(p[:, 8:])
    U = memberships(d1, d2, e[:, 0], e[:, 1])
    return ridge_colors(U, pixels.reshape(-1, R * R, 3).transpose(1, 2), lam)


def tokens(params, colors):
    """19 features: xy/3, (angles - pi)/pi, coefs - 0.5, (colors - .5) * 2
    with the colors channel-major."""
    cf = colors.transpose(-1, -2).reshape(colors.shape[:-2] + (9,))
    return torch.cat([params[..., :4] / 3.0, (params[..., 4:8] - PI) / PI,
                      params[..., 8:10] - 0.5, (cf - 0.5) * 2.0], -1)


# ---------------------------------------------------------------- depth

class DfD:
    """Closed-form depth from a pair of blur levels (utils/depth_etas.py)."""

    def __init__(self, cam: dict, R: int, mag: float):
        s, r1, r2, sc, pp = cam["s"], cam["rho_1"], cam["rho_2"], cam["sigma_cam"], cam["pixel_pitch"]
        nf = R // 2
        self.num = 2.0 * s ** 2 * (r2 - r1)
        self.const = -s * (r1 - r2) * (r1 * s + r2 * s - 2.0)
        self.root = nf * pp * mag / sc
        self.factor = self.root ** 2
        self.b = abs(s * (r2 - r1)) * sc / pp / mag / nf
        self.s = s

    def depth(self, e1, e2):
        b = self.b
        sw = cw = math.sqrt(0.5)                       # the 45 degree line
        sm, cm = math.sin(0.75 * PI), math.cos(0.75 * PI)
        c1 = -sw * e1 + cw * (e2 - b)
        c2 = -sm * (e1 - b) + cm * e2
        c3 = -sw * (e1 - b) + cw * e2
        f1 = torch.where(c1 > 0, (e1 + e2 - b) / 2, torch.where(
            c2 > 0, b + (e1 - e2 - b) / 2, torch.where(c3 < 0, b + (e1 + e2 - b) / 2, e1)))
        f2 = torch.where(c1 > 0, b + (e1 + e2 - b) / 2, torch.where(
            c2 > 0, (e2 - e1 + b) / 2, torch.where(c3 < 0, (e1 + e2 - b) / 2, e2)))
        return self.num / (self.factor * (f1 ** 2 - f2 ** 2) + self.const)

    def sigma(self, depth, rho_prime: float):
        return torch.abs((1.0 / depth - rho_prime) * self.s + 1.0) / self.root


# ---------------------------------------------------------------- render

def bump(v, delta: float = 0.07):
    return torch.exp(-(v ** 2) / delta ** 2)


def depth_mask(d1, d2, hard: bool):
    """0 none, 1 wedge 1, 2 wedge 2: the near-boundary band, or with
    ``hard`` the wedge interiors."""
    if hard:
        m1, m2 = (d1 > 0).int(), (d2 > 0).int() * 2
        return torch.where(m2 == 2, m2, m1)
    m1, m2 = (bump(d1) > 0.5).int(), (bump(d2) > 0.5).int() * 2
    return torch.where((m2 == 2) | (d2 >= 0), m2, m1)


def render(xy_angles, etas, img_patches, R: int, w: float, lam: float, dfd: DfD,
           rho_prime: float, hard: bool):
    """The full render of a patch grid (the program's wedge_render kernel).
    xy_angles (..., 8), etas (..., 4) = (img1 w1, img1 w2, img2 w1, img2 w2),
    img_patches (2, ..., R, R, 3) -> per patch: the pair's renders
    (2, ..., R, R, 3) with one color solve over both images, the sharpened
    and refocused renders, the boundary map, DfD depth and the mask."""
    x, y = pixel_coords(R, xy_angles.dtype, xy_angles.device)
    d1, d2 = wedge_dists(xy_angles, x, y, w)                     # (..., N)
    U = torch.stack([memberships(d1, d2, etas[..., 0], etas[..., 1]),
                     memberships(d1, d2, etas[..., 2], etas[..., 3])])   # (2, ..., 3, N)
    Y = img_patches.reshape(img_patches.shape[:-3] + (R * R, 3)).transpose(-1, -2)
    Ucat = torch.cat([U[0], U[1]], -1)                           # (..., 3, 2N)
    Ycat = torch.cat([Y[0], Y[1]], -1)
    colors = ridge_colors(Ucat, Ycat, lam)                       # (..., 3, 3)

    def paint(u):                                                # (..., 3, N) -> (..., R, R, 3)
        return (u[..., :, :, None] * colors[..., :, None, :]).sum(-3).reshape(
            u.shape[:-2] + (R, R, 3))

    bd = torch.where(d2 >= 0, d2, torch.where(d1.abs() < d2.abs(), d1.abs(), d2.abs()))
    dep1 = dfd.depth(etas[..., 0], etas[..., 2])
    dep2 = dfd.depth(etas[..., 1], etas[..., 3])
    mask = depth_mask(d1, d2, hard)
    depth = torch.where(mask == 1, dep1[..., None], torch.where(mask == 2, dep2[..., None], 0.0))
    sharp = torch.full_like(etas[..., 0], 1e-4)
    any1, any2 = (mask == 1).any(-1), (mask == 2).any(-1)
    sig1 = torch.where(any1, dfd.sigma(dep1, rho_prime), 1e-4)
    sig2 = torch.where(any2, dfd.sigma(dep2, rho_prime), 1e-4)
    lead = xy_angles.shape[:-1] + (R, R)
    return dict(patches=torch.stack([paint(U[0]), paint(U[1])]),
                patches_shpd=paint(memberships(d1, d2, sharp, sharp)),
                patches_refoc=paint(memberships(d1, d2, sig1, sig2)),
                local_bndry=bump(bd).reshape(lead), depth_map=depth.reshape(lead),
                depth_mask=mask.reshape(lead))


# ---------------------------------------------------------------- grids

def unfold(img, R: int, stride: int):
    """(N, H, W, C) -> (N, Hp, Wp, R, R, C)."""
    return img.unfold(1, R, stride).unfold(2, R, stride).permute(0, 1, 2, 4, 5, 3).contiguous()


def fold(p, H: int, W: int, stride: int):
    """Overlap-add (N, Hp, Wp, R, R, C) -> (N, H, W, C)."""
    N, Hp, Wp, R, _, C = p.shape
    cols = p.permute(0, 5, 3, 4, 1, 2).reshape(N, C * R * R, Hp * Wp)
    return F.fold(cols, (H, W), R, stride=stride).permute(0, 2, 3, 1)


def fold_maps(rend, H: int, W: int, stride: int):
    """The folded maps of the estimator from one grid's render (no batch
    axis): confidence (H, W) and global depth (H, W), and the images."""
    R = rend["depth_map"].shape[-1]
    Hp, Wp = rend["depth_map"].shape[:2]
    ones = torch.ones((1, Hp, Wp, R, R, 1), dtype=torch.float32, device=rend["depth_map"].device)
    count = fold(ones, H, W, stride)[0, :, :, 0]

    def fsum(p):                                       # (Hp, Wp, R, R[, C]) -> (H, W[, C])
        c = p if p.dim() == 5 else p[..., None]
        out = fold(c[None], H, W, stride)[0]
        return out if p.dim() == 5 else out[..., 0]

    n = fsum((rend["depth_mask"] > 0).float())
    return dict(confidence=n / count,
                global_depth=fsum(rend["depth_map"]) / torch.where(n > 0, n, 1.0),
                global_image=torch.stack([fsum(rend["patches"][i]) for i in range(2)]) / count[..., None],
                global_shpd=fsum(rend["patches_shpd"]) / count[..., None],
                global_refoc=fsum(rend["patches_refoc"]) / count[..., None],
                global_bndry=fsum(rend["local_bndry"]) / count)
