"""Operations and bytes of each hand-written kernel from its call's shapes,
and the least time the H100 could take for them.

The work counted is what the mathematics needs, not what an implementation
does: each input byte read once and each output byte written once,
float32; a multiply-add counts 2. Attention counts its two products of
4 B H L^2 D forward and the four of the backward, with no factor for how
an implementation reaches float32 grade (3xTF32's three products) or for
recomputing the scores. The least time is the larger of operations over
the configuration's peak (``peaks.py``) and bytes over the HBM rate."""

from __future__ import annotations

from .peaks import HBM_BYTES_PER_S, ops_per_s

F32 = 4
# float32 operations a pixel each wedge kernel's function needs: the
# per-pixel geometry, memberships and sums of the colour solve, and of the
# full render (two images' memberships, the joint solve, the sharpened and
# refocused memberships, four renders, boundary map, depth)
COLORS_OPS_PER_PIXEL = 150
RENDER_OPS_PER_PIXEL = 420


def wedge_colors(P: int, R: int) -> tuple:
    """(ops, bytes) of one launch over P patches: 10 parameters and R*R*3
    pixels in, 3 x 3 colours out a patch."""
    return P * R * R * COLORS_OPS_PER_PIXEL, P * (10 + 3 * R * R + 9) * F32


def wedge_render(B: int, L: int, R: int) -> tuple:
    """(ops, bytes) of one launch over B grids of L patches: 8 geometry
    values, 4 blur levels and both images' R*R*3 pixels in; the pair's
    renders (6), the sharpened and refocused renders (3 + 3), boundary,
    depth and mask (1 + 1 + 1) values a pixel out."""
    return B * L * R * R * RENDER_OPS_PER_PIXEL, B * L * (8 + 4 + 6 * R * R + 15 * R * R) * F32


def flash_fwd(B: int, H: int, L: int, D: int) -> tuple:
    """q k^T and p v: 4 B H L^2 D; q, k, v in, o and the row log-sum-exp out."""
    return 4 * B * H * L * L * D, (4 * B * H * L * D + B * H * L) * F32


def flash_bwd_dkv(B: int, H: int, L: int, D: int) -> tuple:
    """dV = p^T dO and dK = dS^T q: 4 B H L^2 D; q, k, v, dO, lse, di in,
    dk, dv out."""
    return 4 * B * H * L * L * D, (6 * B * H * L * D + 2 * B * H * L) * F32


def flash_bwd_dq(B: int, H: int, L: int, D: int) -> tuple:
    """dP = dO v^T and dQ = dS k: 4 B H L^2 D; q, k, v, dO, lse, di in, dq out."""
    return 4 * B * H * L * L * D, (5 * B * H * L * D + 2 * B * H * L) * F32


KERNELS = {"wedge_colors": wedge_colors, "wedge_render": wedge_render, "flash_fwd": flash_fwd,
           "flash_bwd_dkv": flash_bwd_dkv, "flash_bwd_dq": flash_bwd_dq}


def least_seconds(kernel: str, shape: dict, dtype: str = "float32") -> float:
    """The least time of one launch of ``kernel`` at ``shape`` (its
    function's keyword arguments)."""
    ops, nbytes = KERNELS[kernel](**shape)
    return max(ops / ops_per_s(dtype), nbytes / HBM_BYTES_PER_S)
