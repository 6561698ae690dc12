"""The port's flash attention (plain versions and autograd Function) and the
global stage's attention, dropout and checkpointing, against the JAX
package on the CPU.

- ``flash_attention_plain`` and ``flash_attention_bwd_plain`` against the
  JAX package's ``flash_attention_fn``, which runs the library's Pallas TPU
  kernels (forward, dK/dV, dQ) on the CPU in TPU interpret mode, at
  (1, 256, 8, 16) with a random cotangent. Both sides are float32 and sum in
  another order (the kernel blockwise with an online softmax), so
  max |diff| < 1e-5 for o and 2e-5 for the gradients (measured ~3e-7 and
  ~1e-6 from exact attention).
- The Function's backward against autograd through plain attention, and
  ``attn_impl="flash"`` against ``"xla"``, at a ragged L: float32 against
  float32, atol 1e-5.
- Dropout: the attention mask is one (L, L) mask shared across batch and
  heads (Flax's ``broadcast_dropout``), the others element-wise, at rate
  0.1 by statistics (the random bits cannot match JAX's); a checkpointed
  (recomputed) training forward draws the same masks as a plain one.
- The launch structure of a train step, which ``chip_smoke.py`` checks on
  the card: per step 3 * chunks * layers forward calls (the forward, the
  chunk's recompute, the layer's recompute) and chunks * layers of each
  backward; per eval batch chunks * layers forward calls.
"""

import math

import numpy as np
import numpy.testing as npt
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from blurry_edges_tpu.models.global_stage import flash_attention_fn

from blurry_edges_tpu_torch.config import CamConfig, GridConfig, PatchConfig
from blurry_edges_tpu_torch.models import global_stage as gs
from blurry_edges_tpu_torch.ops import flash_attention as fa
from blurry_edges_tpu_torch.ops.dfd import DfDSolver
from blurry_edges_tpu_torch.train import global_ as tg
from blurry_edges_tpu_torch.utils.seeding import fold_in

torch.set_num_threads(1)  # torch's and XLA-CPU's thread pools share this process

SCALE = 1.0 / math.sqrt(16)


def randn(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def exact_attention(q, k, v):
    """softmax(scale q k^T) v through autograd, (B, H, L, D)."""
    return torch.softmax(q @ k.transpose(-1, -2) * SCALE, dim=-1) @ v


def test_plain_flash_matches_jax_kernel():
    rng = np.random.default_rng(0)
    q, k, v, ct = (randn(rng, 1, 256, 8, 16) for _ in range(4))   # (B, L, H, D)
    with pltpu.force_tpu_interpret_mode():
        o_j, vjp = jax.vjp(flash_attention_fn, *(jnp.asarray(t) for t in (q, k, v)))
        grads_j = vjp(jnp.asarray(ct))

    def bhld(a):
        return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3)))

    qt, kt, vt, ctt = (bhld(a) for a in (q, k, v, ct))
    o, lse = fa.flash_attention_plain(qt, kt, vt, SCALE)
    npt.assert_allclose(o.numpy().transpose(0, 2, 1, 3), np.asarray(o_j), atol=1e-5)
    grads = fa.flash_attention_bwd_plain(qt, kt, vt, o, lse, ctt, SCALE)
    for g, gj in zip(grads, grads_j):
        npt.assert_allclose(g.numpy().transpose(0, 2, 1, 3), np.asarray(gj), atol=2e-5)
    # the lse is the log-sum-exp of the scaled scores
    s = (qt @ kt.transpose(-1, -2) * SCALE).double()
    npt.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(), atol=1e-5)


@pytest.mark.parametrize("L", [121, 130])
def test_flash_function_matches_autograd(L):
    rng = np.random.default_rng(L)
    q, k, v, dout = (torch.from_numpy(randn(rng, 2, 8, L, 16)) for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = fa.flash_attention(*leaves, SCALE)
    o.backward(dout)
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    o_ref = exact_attention(*ref)
    o_ref.backward(dout)
    npt.assert_allclose(o.detach().numpy(), o_ref.detach().numpy(), atol=1e-5)
    for a, b in zip(leaves, ref):
        npt.assert_allclose(a.grad.numpy(), b.grad.numpy(), atol=1e-5)


def test_wrappers_take_plain_version_on_cpu():
    rng = np.random.default_rng(3)
    q, k, v, dout = (torch.from_numpy(randn(rng, 1, 8, 64, 16)) for _ in range(4))
    fa.reset_launch_counts()
    o, lse = fa.flash_attention_fwd(q, k, v, SCALE)
    o_p, lse_p = fa.flash_attention_plain(q, k, v, SCALE)
    assert torch.equal(o, o_p) and torch.equal(lse, lse_p)
    for a, b in zip(fa.flash_attention_bwd(q, k, v, o, lse, dout, SCALE),
                    fa.flash_attention_bwd_plain(q, k, v, o, lse, dout, SCALE)):
        assert torch.equal(a, b)
    # a launch count counts kernel launches, and the CPU launches none
    assert fa.launch_counts() == {"flash_fwd": 0, "flash_bwd_dkv": 0, "flash_bwd_dq": 0}


def test_flash_self_attention_equals_xla():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(randn(rng, 2, 121, 128))
    xla = gs.SelfAttention(128, 8, attn_impl="xla")
    flash = gs.SelfAttention(128, 8, attn_impl="flash")
    flash.load_state_dict(xla.state_dict())
    outs, grads = [], []
    for mod in (xla, flash):
        xi = x.clone().requires_grad_()
        out = mod(xi)
        out.square().sum().backward()
        outs.append(out.detach().numpy())
        grads.append(xi.grad.numpy())
    npt.assert_allclose(outs[1], outs[0], atol=1e-5)
    npt.assert_allclose(grads[1], grads[0], atol=1e-4)   # sums of ~1e3 products


def test_attention_dropout_mask_is_shared_across_batch_and_heads():
    B, H, L, rate = 2, 8, 256, 0.1
    x = torch.ones(B, H, L, L)
    y = gs.keyed_dropout(x, rate, seed=7, shape=(1, 1, L, L))
    kept = y != 0
    assert torch.equal(kept, kept[:1, :1].expand_as(kept))       # one (L, L) mask
    frac = 1.0 - kept[0, 0].float().mean().item()
    assert abs(frac - rate) < 5 * math.sqrt(rate * (1 - rate) / (L * L))
    npt.assert_allclose(y[kept].numpy(), 1.0 / (1.0 - rate), rtol=1e-6)
    # the same seed draws the same mask; another seed another
    assert torch.equal(gs.keyed_dropout(x, rate, 7, (1, 1, L, L)), y)
    assert not torch.equal(gs.keyed_dropout(x, rate, 8, (1, 1, L, L)), y)


def test_residual_dropout_is_elementwise():
    x = torch.ones(4, 512, 128)
    kept = gs.keyed_dropout(x, 0.1, seed=3) != 0
    assert not torch.equal(kept[0], kept[1])
    frac = 1.0 - kept.float().mean().item()
    assert abs(frac - 0.1) < 5 * math.sqrt(0.09 / kept.numel())
    assert torch.equal(gs.keyed_dropout(x, 0.1, None), x)     # no seed: no dropout
    assert torch.equal(gs.keyed_dropout(x, 0.0, 3), x)


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_checkpointed_training_forward_redraws_the_same_masks(attn_impl):
    """Gradients through the checkpointed layers (recomputed in backward)
    equal those of the same layers run without checkpointing."""
    torch.manual_seed(0)
    model = gs.GlobalStage(num_encoder_layers=2, dropout=0.1, attn_impl=attn_impl)
    src = torch.randn(2, 121, 38)
    seed = 1234

    def plain_forward():
        x = model.in_src_projection(src) + model.pe[None, :src.shape[1], :]
        for i, layer in enumerate(model.encoder.layers):
            x = layer(x, fold_in(seed, i))
        return model.generator(model.encoder.norm(x))

    grads = []
    for fwd in (lambda: model(src, train=True, seed=seed), plain_forward):
        model.zero_grad()
        fwd().square().mean().backward()
        grads.append([p.grad.clone() for p in model.parameters()])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    with torch.no_grad():
        eval_out = model(src)
        assert not torch.equal(model(src, train=True, seed=seed), eval_out)
        assert torch.equal(model(src, train=True, seed=seed),
                           model(src, train=True, seed=seed))


def test_flash_calls_per_step_and_eval_batch(monkeypatch):
    """The counts chip_smoke.py holds the card's launches to."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = fa.flash_attention_fwd, fa.flash_attention_bwd

    def count_fwd(*a):
        calls["fwd"] += 1
        return fwd(*a)

    def count_bwd(*a):
        calls["bwd"] += 1
        return bwd(*a)

    monkeypatch.setattr(fa, "flash_attention_fwd", count_fwd)
    monkeypatch.setattr(fa, "flash_attention_bwd", count_bwd)
    H = 29
    grid, patch = GridConfig(H=H, W=H), PatchConfig()
    dfd = DfDSolver.from_config(CamConfig(), patch)
    rng = np.random.default_rng(9)
    B, L, n_layers = 4, grid.num_tokens, 2
    batch = {"input_param": torch.from_numpy(randn(rng, B, 2, L, 19) * 0.3),
             "img_gt": torch.rand(B, 2, H, H, 3), "img_ny": torch.rand(B, 2, H, H, 3),
             "bndry_dist": torch.randint(0, 10, (B, H, H)).float(),
             "deri": torch.rand(B, 2, H - 2, H - 2, 3),
             "bndry_depth": torch.rand(B, H, H)}
    gammas = torch.full((7,), 0.5)
    for chunks in (1, 2):
        model = gs.GlobalStage(num_encoder_layers=n_layers, attn_impl="flash")
        opt = tg.init_state(model, 0, 1e-4)
        step, ev = tg.make_step_fns(model, opt, patch, grid, dfd, grad_accum=chunks)
        calls.update(fwd=0, bwd=0)
        step(batch, gammas, 1)
        # no chunk checkpoint when chunks == 1: the layer's recompute only
        want_fwd = (3 if chunks > 1 else 2) * chunks * n_layers
        assert calls == {"fwd": want_fwd, "bwd": chunks * n_layers}
        calls.update(fwd=0, bwd=0)
        ev(batch, gammas)
        assert calls == {"fwd": chunks * n_layers, "bwd": 0}
