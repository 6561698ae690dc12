"""One optimizer step of the port's global-stage trainer against the JAX
package's ``make_step_fns``, on the CPU.

From the same Flax initialisation (bridged with ``jax_global_to_torch``), a
one-layer GlobalStage at 41x41 (121 tokens) takes one AdamW step with the
gradient clipped at 1.0 on the same batch, with ``grad_accum`` 1 and 2 (the
port's chunks run under activation checkpointing, the JAX package's under
a checkpointed scan). Dropout is 0.0 on both sides, since the random bits
cannot match. The JAX side runs ``attn_impl="xla"``: its flash kernel
cannot run in TPU interpret mode under checkpointing. The port runs both
of its attentions, which compute the same exact attention.

The loss's gradient is ill-conditioned where a blur level eta nears its
floor of 1e-4 (erf slopes ~1/eta): from the Xavier initialisation the
generator's outputs put many etas there, and the ~3e-7 by which the
global stage's float32 output differs from its float64 output moves the
gradient by over 1e-3 (``test_loss_gradient_conditioning``: 0.13 at its
seed, 3.8e-5 with the generator's kernel scaled by 1/4). Both sides
therefore start from the initialisation with the generator's kernel scaled
by 1/4, where the etas sit in the loss's well-conditioned range; the
optimizer step is the same.

Tolerances: the loss rtol 1e-5 (float32 on both sides; the port's 3x3
inverse runs in float64). Adam's first step moves each parameter by about
lr * g / (|g| + eps), nearly its sign, so the updated parameters are
compared through the update over lr: under 2e-3 apart wherever the
gradient is at least 1e-3 of the gradients' RMS (below that, float32
noise decides the sign; measured: no entry above the line apart), and
every entry within 2, the update's range.
"""

import functools

import numpy as np
import numpy.testing as npt
import pytest
import torch

import jax
import jax.numpy as jnp

from blurry_edges_tpu.config import CamConfig as JaxCam, GridConfig as JaxGrid
from blurry_edges_tpu.config import PatchConfig as JaxPatch
from blurry_edges_tpu.models import GlobalStage as JaxGlobalStage
from blurry_edges_tpu.ops.dfd import DfDSolver as JaxDfD
from blurry_edges_tpu.train import global_ as jtg

from blurry_edges_tpu_torch.config import CamConfig, GridConfig, PatchConfig
from blurry_edges_tpu_torch.models.global_stage import GlobalStage
from blurry_edges_tpu_torch.ops.dfd import DfDSolver
from blurry_edges_tpu_torch.train import global_ as tg
from blurry_edges_tpu_torch.train.optim import make_optimizer
from blurry_edges_tpu_torch.models.weights import jax_global_to_torch

torch.set_num_threads(1)  # torch's and XLA-CPU's thread pools share this process

H, B, LR = 41, 2, 1e-4
GRID, JGRID = GridConfig(H=H, W=H), JaxGrid(H=H, W=H)
PATCH, JPATCH = PatchConfig(), JaxPatch()
DFD, JDFD = DfDSolver.from_config(CamConfig(), PATCH), JaxDfD.from_config(JaxCam(), JPATCH)
L = GRID.num_tokens
GENERATOR_SCALE = 0.25
GAMMAS = np.asarray([0.7, 0.2, 0.05, 0.1, 0.1, 0.05, 0.5], np.float32)


def batch_np():
    rng = np.random.default_rng(11)
    bd = np.zeros((B, H, H), np.float32)
    bd[:, ::5, :] = rng.uniform(0.75, 1.18, (B, (H + 4) // 5, H))
    return {"input_param": rng.normal(scale=0.3, size=(B, 2, L, 19)).astype(np.float32),
            "img_gt": rng.uniform(0, 1, (B, 2, H, H, 3)).astype(np.float32),
            "bndry_dist": rng.integers(0, 10, (B, H, H)).astype(np.float32),
            "deri": rng.uniform(0, 1, (B, 2, H - 2, H - 2, 3)).astype(np.float32),
            "bndry_depth": bd}


@functools.lru_cache(maxsize=None)
def jax_step(grad_accum):
    """(initial params, loss, updated params) of the JAX package's step."""
    model = JaxGlobalStage(num_encoder_layers=1, dropout=0.0, attn_impl="xla")
    state, tx = jtg.init_state(model, jax.random.PRNGKey(3), LR, L)
    params = jax.tree.map(lambda a: a, state.params)
    params["generator"]["kernel"] = params["generator"]["kernel"] * GENERATOR_SCALE
    state = state.replace(params=params)
    train_step, _ = jtg.make_step_fns(model, tx, JPATCH, JGRID, JDFD, grad_accum)
    batch = {k: jnp.asarray(v) for k, v in batch_np().items()}
    new, loss = jax.jit(train_step)(state, batch, jnp.asarray(GAMMAS), jax.random.PRNGKey(0))
    to_np = functools.partial(jax.tree.map, np.asarray)
    return to_np(state.params), float(loss), to_np(new.params)


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
@pytest.mark.parametrize("grad_accum", [1, 2])
def test_one_step_matches_jax(grad_accum, attn_impl):
    p0, loss_j, p1 = jax_step(grad_accum)
    model = GlobalStage(num_encoder_layers=1, dropout=0.0, attn_impl=attn_impl)
    model.load_state_dict(jax_global_to_torch(p0))
    opt = make_optimizer(model.parameters(), LR)
    train_step, eval_step = tg.make_step_fns(model, opt, PATCH, GRID, DFD, grad_accum)
    batch = {k: torch.from_numpy(v) for k, v in batch_np().items()}
    before = {k: v.clone() for k, v in model.state_dict().items()}
    loss = train_step(batch, torch.from_numpy(GAMMAS), 0)
    npt.assert_allclose(float(loss), loss_j, rtol=1e-5)
    want0, want1 = jax_global_to_torch(p0), jax_global_to_torch(p1)
    grads = dict(model.named_parameters())
    ours, theirs, g = (np.concatenate(x) for x in zip(*(
        (((v - before[k]) / LR).numpy().ravel(),
         ((want1[k] - want0[k]) / LR).numpy().ravel(),
         grads[k].grad.numpy().ravel()) for k, v in model.state_dict().items())))
    d = np.abs(ours - theirs)
    assert d.max() <= 2.0
    clear = np.abs(g) >= 1e-3 * np.sqrt(np.mean(g.astype(np.float64) ** 2))
    assert clear.mean() > 0.75
    assert d[clear].max() < 2e-3, d[clear].max()
    # the step moved the parameters: about lr an entry
    assert np.median(np.abs(ours)) > 0.5


@pytest.mark.parametrize("generator_scale", [1.0, GENERATOR_SCALE])
def test_loss_gradient_conditioning(generator_scale):
    """Why the step tests scale the generator: the loss's gradient with
    respect to the global stage's output, in float64, at the float64
    forward's output and at the float32 forward's (a change of ~3e-7),
    moves by over 1e-3 from the Xavier init and by under 1e-4 from the
    scaled one."""
    from blurry_edges_tpu_torch.train.optim import xavier_reinit

    model = GlobalStage(num_encoder_layers=1, dropout=0.0)
    xavier_reinit(model, torch.Generator().manual_seed(5))
    with torch.no_grad():
        model.generator.weight.mul_(generator_scale)
    b = batch_np()
    tokens = tg.tokens_from_params_src(torch.from_numpy(b["input_param"]))
    with torch.no_grad():
        est32 = model(tokens).double()
        est64 = model.double()(tokens.double())
    rest = [torch.from_numpy(b[k]).double()
            for k in ("img_gt", "img_gt", "bndry_dist", "deri", "bndry_depth")]

    def grad_at(est):
        e = est.clone().requires_grad_()
        tg.global_loss(e, *rest, torch.from_numpy(GAMMAS).double(), PATCH, GRID,
                       DFD).backward()
        return e.grad

    g32, g64 = grad_at(est32), grad_at(est64)
    moved = ((g32 - g64).norm() / g64.norm()).item()
    print(f"generator x{generator_scale}: output change "
          f"{((est32 - est64).norm() / est64.norm()).item():.2g}, gradient change {moved:.2g}")
    if generator_scale == 1.0:
        assert moved > 1e-3
    else:
        assert moved < 1e-4
