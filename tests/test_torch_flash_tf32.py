"""A CPU rehearsal of the arithmetic of the tensor-core flash kernels
(csrc/flash_attn_fwd.cu, csrc/flash_attn_bwd_dkv.cu,
csrc/flash_attn_bwd_dq.cu): 3xTF32.

Each float32 operand x of a product splits into big = tf32(x) and small =
tf32(x - big), ``cvt.rna.tf32.f32`` emulated here (round to nearest on the
low 13 mantissa bits, ties away from zero), and a*b is taken as
small_a*big_b + big_a*small_b + big_a*big_b in float32. The plain flash
forward and backward with every product split so (P and dS included) must
stay within the tolerances the kernels are held to on the card
(chip_smoke.py, tests/test_torch_cuda.py) against a float64 evaluation:
1e-5 * scale for o and lse, 1e-4 * scale for dk, dv and dq (scale: the largest
|value| of the float64 result, at least 1). What one TF32 pass gives is
printed, not asserted (run with -s).
"""

import math

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

SHAPE = (1, 8, 512, 16)
SCALE = 0.25  # 1/sqrt(16)
TILE_K = 64   # keys a tile of the dQ kernel


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: keep 10 mantissa bits, rounded to nearest, ties
    away from zero (on the magnitude bits, whatever the sign)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    big = tf32(x)
    return big, tf32(x - big)


def mm3(a, b):
    """a @ b in 3xTF32, the small terms first, as the kernels sum them."""
    (ab, as_), (bb, bs) = split(a), split(b)
    return (as_ @ bb + ab @ bs) + ab @ bb


def mm1(a, b):
    return tf32(a) @ tf32(b)


def attention(q, k, v, dout, mm):
    """o, lse, dk, dv, dq of softmax(SCALE * q k^T) v with every product by
    mm, in the kernels' order: scores in base-2 units from q (forward, dQ) or
    k (dK/dV) scaled by SCALE * log2(e) before the split, exp2, and
    lse = m * ln(2) + log(l); dQ sums each 64-key tile's dS K in a fresh
    accumulator and adds the tiles in order."""
    c = SCALE * math.log2(math.e)
    s = mm(q * c, k.transpose(-1, -2))
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(-1, keepdim=True)
    o = mm(p, v) / l
    lse = (m * math.log(2) + torch.log(l))[..., 0]
    pt = torch.exp2(mm(k * c, q.transpose(-1, -2)) - lse[..., None, :] * math.log2(math.e))
    di = (o * dout).sum(-1)
    dv = mm(pt, dout)
    dst = pt * (mm(v, dout.transpose(-1, -2)) - di[..., None, :])
    dk = mm(dst, q) * SCALE
    p = torch.exp2(mm(q * c, k.transpose(-1, -2)) - lse[..., None] * math.log2(math.e))
    ds = p * (mm(dout, v.transpose(-1, -2)) - di[..., None])
    dq = torch.zeros_like(q)
    for t0 in range(0, k.shape[-2], TILE_K):
        dq = dq + mm(ds[..., t0:t0 + TILE_K], k[..., t0:t0 + TILE_K, :])
    return {"o": o, "lse": lse, "dk": dk, "dv": dv, "dq": dq * SCALE}


@pytest.fixture(scope="module")
def results():
    rng = np.random.default_rng(6)
    arrays = [rng.standard_normal(SHAPE).astype(np.float32) for _ in range(4)]
    f32 = [torch.from_numpy(a) for a in arrays]
    exact = attention(*[t.double() for t in f32], torch.matmul)
    errors = {}
    for name, mm in (("3xTF32", mm3), ("TF32", mm1), ("float32", torch.matmul)):
        got = attention(*f32, mm)
        errors[name] = {k: ((got[k].double() - exact[k]).abs().max().item(),
                            max(1.0, exact[k].abs().max().item())) for k in exact}
    print("\nmax |error| against float64 at", SHAPE, ":",
          {n: {k: f"{e:.3g}" for k, (e, _) in errs.items()} for n, errs in errors.items()})
    return errors


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                       # TF32's unit in the last place at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2.0 ** -23,
                      one + 3 * ulp / 2, 3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + 2 * ulp, 3.0, 0.0],
                        dtype=torch.float32)
    assert torch.equal(tf32(x), want)
    y = torch.from_numpy(np.random.default_rng(1).standard_normal(1000).astype(np.float32))
    big, small = split(y)
    assert (big.view(torch.int32) & 0x1FFF).eq(0).all()
    assert (small.view(torch.int32) & 0x1FFF).eq(0).all()
    assert ((big.double() + small.double() - y.double()).abs()
            <= y.double().abs() * 2.0 ** -21).all()


@pytest.mark.parametrize("name,tol", [("o", 1e-5), ("lse", 1e-5), ("dk", 1e-4), ("dv", 1e-4),
                                      ("dq", 1e-4)])
def test_3xtf32_within_the_kernel_tolerances(results, name, tol):
    err, scale = results["3xTF32"][name]
    assert err < tol * scale, f"{name}: {err} >= {tol} * {scale}"
    # and float32-grade: within 4x of plain float32's own error
    assert err < 4 * max(results["float32"][name][0], 1e-7)
