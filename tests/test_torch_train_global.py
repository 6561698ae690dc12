"""The port's global-stage trainer (blurry_edges_tpu_torch.train.global_ and
what it calls) against the JAX package's, on the same numpy inputs, on the
CPU.

- The ops the loss adds (Sobel, the flat unfold and fold, the training
  denormalization, the flat boundary field and masks): float32 formulas on
  both sides, rtol/atol 1e-5 unless a case says otherwise.
- ``global_loss_terms`` and the gradient of ``global_loss`` with respect to
  the global stage's output, at 41x41 (121 tokens), with the soft and the
  hard depth masks. The port runs its 3x3 inverse in float64 where the JAX
  package runs float32 (ROADMAP.md section 3), and the wedge cascade
  (erf slopes ~1/eta, eta down to 1e-4) amplifies last-bit differences in
  the gradient; the terms are held to rtol 1e-5 (the two consistency terms
  1e-3, as the test says), the depth count exactly, the gradient to a
  relative L2 error under 1e-3 and a cosine above 0.99999.
- The schedules and the plateau scheduler: exact.
- The optimizer's traps: AdamW with optax's defaults (weight decay 1e-4,
  not torch's 0.01) and optax's clip (max/norm, not max/(norm + 1e-6)),
  three steps against optax on the same gradients, rtol 1e-6; the Xavier
  re-initialisation's per-leaf standard deviation against the JAX package's
  ``xavier_reinit`` (fans of the Flax shapes), within 10% (sampling: the
  smallest leaf has 1,536 entries), biases zero, norm scales one.
- The compact batch round trip against the JAX package's
  ``expand_compact_batch``; checkpoints and step snapshots, with a run that
  stops mid-epoch and resumes to the same weights as a run that did not
  stop; and the entry point ``run_global_training(..., device="cpu")`` on a
  tiny dataset.
"""

import argparse
import math

import numpy as np
import numpy.testing as npt
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from blurry_edges_tpu.config import CamConfig as JaxCam, GridConfig as JaxGrid
from blurry_edges_tpu.config import PatchConfig as JaxPatch
from blurry_edges_tpu.models import GlobalStage as JaxGlobalStage
from blurry_edges_tpu.ops import params as jparams
from blurry_edges_tpu.ops import patchify as jpatch
from blurry_edges_tpu.ops import sobel as jsobel
from blurry_edges_tpu.ops import wedge as jw
from blurry_edges_tpu.ops.dfd import DfDSolver as JaxDfD
from blurry_edges_tpu.train import global_ as jtg
from blurry_edges_tpu.train import local as jlocal
from blurry_edges_tpu.train import schedules as jsched

from blurry_edges_tpu_torch import cli
from blurry_edges_tpu_torch.config import (CamConfig, GridConfig, PatchConfig,
                                           get_args)
from blurry_edges_tpu_torch.models.global_stage import GlobalStage
from blurry_edges_tpu_torch.ops import params, patchify, sobel, wedge
from blurry_edges_tpu_torch.ops.dfd import DfDSolver
from blurry_edges_tpu_torch.train import checkpoint, optim, resume, schedules
from blurry_edges_tpu_torch.train import global_ as tg

torch.set_num_threads(1)  # torch's and XLA-CPU's thread pools share this process

H = 41
GRID, JGRID = GridConfig(H=H, W=H), JaxGrid(H=H, W=H)
PATCH, JPATCH = PatchConfig(), JaxPatch()
DFD, JDFD = DfDSolver.from_config(CamConfig(), PATCH), JaxDfD.from_config(JaxCam(), JPATCH)
L = GRID.num_tokens
GAMMA_RANGES = {
    "color": (1.0, 0.1, 0.1), "color_cons": (0.2, 0.1, 0.05),
    "bndry_cons": (0.05, 0.05, 0.02), "smthns": (0.005, 0.1, 0.002),
    "smthns_cons": (0.005, 0.1, 0.002), "bndry_loc": (0.0001, 0.05, 0.0001),
    "depth": (0.0001, 0.05, 0.5),
}


def t(a):
    return torch.tensor(np.asarray(a))


def close(ours, theirs, rtol=1e-5, atol=1e-5):
    npt.assert_allclose(np.asarray(ours), np.asarray(theirs), rtol=rtol, atol=atol)


def loss_inputs(rng, B):
    """(est, img_for_colors, img_gt, bndry_dist, deri, bndry_depth), numpy."""
    bd = np.zeros((B, H, H), np.float32)
    ring = rng.uniform(0, 1, size=(B, H, H)) < 0.08
    bd[ring] = rng.uniform(0.75, 1.18, size=int(ring.sum()))
    return (rng.normal(scale=0.3, size=(B, L, 12)).astype(np.float32),
            rng.uniform(0, 1, (B, 2, H, H, 3)).astype(np.float32),
            rng.uniform(0, 1, (B, 2, H, H, 3)).astype(np.float32),
            rng.integers(0, 20, (B, H, H)).astype(np.float32),
            rng.uniform(0, 1, (B, 2, H - 2, H - 2, 3)).astype(np.float32),
            bd)


# ---------------------------------------------------------------- ops


def test_sobel_matches_jax():
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 1, (3, 2, 23, 25, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jsobel.image_derivative(jnp.asarray(img))
        p = jnp.asarray(img[0, 0, :21, :21, 0].reshape(1, 441))
        want_flat = jsobel.image_derivative_flat(p, 21)
    close(sobel.image_derivative(t(img)), want)
    close(sobel.image_derivative_flat(t(p), 21), want_flat)
    # the flat form is the image form on one patch
    close(sobel.image_derivative_flat(t(p), 21).reshape(19, 19),
          sobel.image_derivative(t(img[0, 0, :21, :21, :1]))[..., 0])


def test_flat_unfold_and_fold_match_jax():
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 1, (2, H, H, 3)).astype(np.float32)
    got = patchify.unfold_flat_cm(t(img), 21, 2)
    close(got, jpatch.unfold_flat_cm(jnp.asarray(img), 21, 2), 0, 0)
    close(got.permute(0, 2, 3, 1).reshape(2, 11, 11, 21, 21, 3),
          patchify.unfold(t(img), 21, 2), 0, 0)
    flat = rng.uniform(0, 1, (3, L, 441)).astype(np.float32)
    close(patchify.fold_flat(t(flat), H, H, 21, 2),
          jpatch.fold_flat(jnp.asarray(flat), H, H, 21, 2))
    with pytest.raises(ValueError):
        patchify.fold_flat(t(flat[:, :-1]), H, H, 21, 2)


def test_train_denormalization_and_flat_fields_match_jax():
    rng = np.random.default_rng(3)
    est = rng.normal(scale=0.5, size=(5, 7, 12)).astype(np.float32)
    xy, etas = params.denormalize_global_train(t(est))
    jxy, jetas = jparams.denormalize_global_train(jnp.asarray(est))
    close(xy, jxy)
    close(etas, jetas)
    d1, d2 = (rng.normal(scale=0.2, size=(6, 441)).astype(np.float32) for _ in range(2))
    close(wedge.boundary_distance_field_flat(t(d1), t(d2)),
          jw.boundary_distance_field_flat(jnp.asarray(d1), jnp.asarray(d2)), 0, 0)
    for hard in (False, True):
        got = wedge.depth_masks_flat(t(d1), t(d2), hard=hard)
        assert got.dtype == torch.int32
        npt.assert_array_equal(got.numpy(), np.asarray(
            jw.depth_masks_flat(jnp.asarray(d1), jnp.asarray(d2), hard=hard)))


def test_tokens_from_params_src():
    ps = np.random.default_rng(4).normal(size=(3, 2, 10, 19)).astype(np.float32)
    out = tg.tokens_from_params_src(t(ps))
    npt.assert_array_equal(out.numpy(), np.asarray(jtg.tokens_from_params_src(jnp.asarray(ps))))


# ---------------------------------------------------------------- loss


LOSS_GAMMAS = np.asarray([0.7, 0.2, 0.05, 0.1, 0.1, 0.05, 0.5], np.float32)


@pytest.fixture(scope="module")
def jax_loss():
    """The JAX package's terms, loss and gradient for both depth masks on one
    seeded input, from one compiled program (a compile of the loss takes
    ~25 s on a CPU)."""
    inputs = loss_inputs(np.random.default_rng(5), 2)

    def value_and_grad(e, *rest, hard):
        def loss(e):
            terms, S, N = jtg.global_loss_terms(e, *rest, JPATCH, JGRID, JDFD,
                                                hard_mask=hard)
            return jnp.sum(jnp.asarray(LOSS_GAMMAS)[:6] * terms) + LOSS_GAMMAS[6] * S / N, \
                (terms, S, N)
        return jax.value_and_grad(loss, has_aux=True)(e)

    def both(*args):
        return {hard: value_and_grad(*args, hard=hard) for hard in (False, True)}

    with jax.default_matmul_precision("highest"):
        out = jax.jit(both)(*(jnp.asarray(a) for a in inputs))
    return inputs, out


@pytest.mark.parametrize("hard_mask", [False, True])
def test_loss_terms_and_gradient_match_jax(jax_loss, hard_mask):
    inputs, out = jax_loss
    (loss_j, (terms_j, S_j, N_j)), grad_j = out[hard_mask]
    e = t(inputs[0]).requires_grad_()
    targs = [t(a) for a in inputs[1:]]
    terms, S, N = tg.global_loss_terms(e, *targs, PATCH, GRID, DFD, hard_mask=hard_mask)
    # the consistency terms (1: color, 4: smoothness) are a render against the
    # fold of the same render, ~1e-3 of its size: their relative error is
    # ~1e3 times the render's (measured 2.6e-4 and 5.8e-5)
    close(terms.detach()[[0, 2, 3, 5]], np.asarray(terms_j)[[0, 2, 3, 5]], rtol=1e-5, atol=0)
    close(terms.detach()[[1, 4]], np.asarray(terms_j)[[1, 4]], rtol=1e-3, atol=0)
    close(S.detach(), S_j, rtol=1e-5, atol=0)
    assert float(N) == float(N_j) > 0
    loss = (t(LOSS_GAMMAS)[:6] * terms).sum() + LOSS_GAMMAS[6] * S / N
    close(tg.global_loss(e.detach(), *targs, t(LOSS_GAMMAS), PATCH, GRID, DFD,
                         hard_mask=hard_mask), loss.detach(), rtol=1e-7, atol=0)
    loss.backward()
    close(loss.detach(), loss_j, rtol=1e-5, atol=0)
    # measured: relative L2 8.5e-5, cosine 1 - 4e-8
    a, b = e.grad.numpy().ravel().astype(np.float64), np.asarray(grad_j).ravel()
    assert np.linalg.norm(a - b) / np.linalg.norm(b) < 1e-3
    assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) > 0.99999


def test_hard_mask_changes_the_depth_term():
    args = [t(a) for a in loss_inputs(np.random.default_rng(6), 1)]
    _, S_soft, N_soft = tg.global_loss_terms(*args, PATCH, GRID, DFD, hard_mask=False)
    _, S_hard, N_hard = tg.global_loss_terms(*args, PATCH, GRID, DFD, hard_mask=True)
    assert float(N_soft) != float(N_hard)


# ---------------------------------------------------------------- schedules


def test_schedules_match_jax():
    for epoch in range(0, 230, 7):
        assert (schedules.gamma_schedule(epoch, (30, 100, 200), GAMMA_RANGES)
                == jsched.gamma_schedule(epoch, (30, 100, 200), GAMMA_RANGES))
        assert (schedules.beta_schedule(epoch, 200, 1e-3, 5e-4)
                == jsched.beta_schedule(epoch, 200, 1e-3, 5e-4))
        assert schedules.local_patience(epoch) == jsched.local_patience(epoch)
    assert schedules.final_gamma(GAMMA_RANGES) == jsched.final_gamma(GAMMA_RANGES)
    npt.assert_array_equal(
        tg.gammas_to_array(schedules.final_gamma(GAMMA_RANGES)).numpy(),
        np.asarray(jtg.gammas_to_array(jsched.final_gamma(GAMMA_RANGES))))


def test_plateau_scheduler_matches_jax():
    rng = np.random.default_rng(7)
    metrics = np.concatenate([np.linspace(1.0, 0.5, 10), 0.5 + rng.uniform(0, 0.01, 40)])
    ours = schedules.PlateauScheduler(lr=1e-4, factor=0.975, patience=5, min_lr=5e-5)
    theirs = jsched.PlateauScheduler(lr=1e-4, factor=0.975, patience=5, min_lr=5e-5)
    lrs = [(ours.step(m), theirs.step(m)) for m in metrics]
    assert all(a == b for a, b in lrs)
    assert lrs[-1][0] < 1e-4   # the plateau lowered the rate


# ---------------------------------------------------------------- optimizer


def test_adamw_with_clip_matches_optax():
    rng = np.random.default_rng(8)
    p0 = [rng.normal(size=s).astype(np.float32) for s in ((4, 3), (3,), (5,))]
    grads = [[rng.normal(scale=sc, size=p.shape).astype(np.float32) for p in p0]
             for sc in (3.0, 0.05, 2.0)]   # clipped, not clipped, clipped
    tx = jlocal.make_optimizer(1e-3)
    jp = [jnp.asarray(p) for p in p0]
    state = tx.init(jp)
    ps = [torch.nn.Parameter(t(p)) for p in p0]
    opt = optim.make_optimizer(ps, 1e-3)
    for i, g in enumerate(grads):
        if i == 2:    # a new learning rate, set as the plateau gate sets it
            state = jlocal.set_lr(state, 5e-4)
            optim.set_lr(opt, 5e-4)
        upd, state = tx.update([jnp.asarray(a) for a in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, a in zip(ps, g):
            p.grad = t(a)
        norm = optim.clip_by_global_norm_(ps, 1.0)
        npt.assert_allclose(float(norm), math.sqrt(sum((a.astype(np.float64) ** 2).sum()
                                                       for a in g)), rtol=1e-6)
        opt.step()
        for p, q in zip(ps, jp):
            close(p.detach(), q, rtol=1e-6, atol=1e-7)
    assert optim.current_lr(opt) == 5e-4 == pytest.approx(jlocal.current_lr(state))
    assert opt.defaults["weight_decay"] == 1e-4
    assert opt.defaults["betas"] == (0.9, 0.999) and opt.defaults["eps"] == 1e-8


def test_xavier_reinit_matches_jax_fans():
    jmodel = JaxGlobalStage(num_encoder_layers=2)
    jvars = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 38)))
    jparams_ = jlocal.xavier_reinit(jvars["params"], jax.random.PRNGKey(1))
    model = GlobalStage(num_encoder_layers=2)
    optim.xavier_reinit(model, torch.Generator().manual_seed(0))
    sd = model.state_dict()
    d = 128

    def pairs(i):
        lp, pre = jparams_[f"layer{i}"], f"encoder.layers.{i}"
        att = lp["self_attn"]
        w = sd[f"{pre}.self_attn.in_proj_weight"]
        yield w[:d], att["query"]["kernel"], math.sqrt(2 / 3072)
        yield w[d:2 * d], att["key"]["kernel"], math.sqrt(2 / 3072)
        yield w[2 * d:], att["value"]["kernel"], math.sqrt(2 / 3072)
        yield sd[f"{pre}.self_attn.out_proj.weight"], att["out"]["kernel"], math.sqrt(2 / 1152)
        yield sd[f"{pre}.linear1.weight"], lp["linear1"]["kernel"], math.sqrt(2 / 384)
        yield sd[f"{pre}.linear2.weight"], lp["linear2"]["kernel"], math.sqrt(2 / 384)

    leaves = [(sd["in_src_projection.weight"], jparams_["in_proj"]["kernel"],
               math.sqrt(2 / 166)),
              (sd["generator.weight"], jparams_["generator"]["kernel"], math.sqrt(2 / 140))]
    for i in range(2):
        leaves += list(pairs(i))
    for ours, theirs, want in leaves:
        s_ours, s_theirs = ours.std().item(), float(np.std(np.asarray(theirs)))
        assert abs(s_theirs / want - 1) < 0.1, (s_theirs, want)
        assert abs(s_ours / want - 1) < 0.1, (s_ours, want)
        assert ours.abs().max().item() <= 2 * want / 0.8796 + 1e-6   # truncated at 2 std
    for name, p in sd.items():
        if name.endswith("bias"):
            assert torch.count_nonzero(p) == 0, name
        elif "norm" in name:
            assert torch.equal(p, torch.ones_like(p)), name


# ---------------------------------------------------------------- data


def test_compact_batch_round_trip_matches_jax():
    rng = np.random.default_rng(9)
    B = 2
    alphas = rng.uniform(180, 200, (B,)).astype(np.float32)
    imgs = rng.integers(0, 256, (B, 2, H, H, 3)).astype(np.float32)
    a = alphas[:, None, None, None, None]
    img_gt = (imgs / 255.0 * a).astype(np.float32)
    ny = np.clip(np.round(img_gt + rng.normal(0, 2, imgs.shape)), 0, 200).astype(np.uint8)
    compact = {"input_param": rng.normal(size=(B, 2, L, 19)).astype(np.float32),
               "imgs_u8": np.round(img_gt / a * 255.0).astype(np.uint8),
               "bndry_dist": rng.integers(0, 300, (B, H, H)).astype(np.uint16),
               "bndry_depth": rng.uniform(0.75, 1.18, (B, H, H)).astype(np.float32),
               "ny_u8": ny, "alpha": alphas}
    npt.assert_array_equal(compact["imgs_u8"], imgs.astype(np.uint8))
    ours = tg.expand_compact_batch(tg.to_device_batch(compact, "cpu", bf16_tokens=True))
    with jax.default_matmul_precision("highest"):
        theirs = jtg.expand_compact_batch(
            {k: jnp.asarray(v, jnp.bfloat16 if k == "input_param" else None)
             for k, v in compact.items()})
    assert set(ours) == set(theirs)
    for k in ours:
        close(ours[k], theirs[k], rtol=1e-5, atol=1e-6)
    close(ours["img_gt"], imgs / 255.0, rtol=1e-6, atol=0)
    assert tg.expand_compact_batch(ours) is ours    # expanded batches pass through
    # the host-side compaction of a dataset's arrays
    ds = argparse.Namespace(alpha=alphas, img_gt=img_gt, input_param=compact["input_param"],
                            bndry_dist=compact["bndry_dist"].astype(np.float32),
                            bndry_depth=compact["bndry_depth"], img_ny=ny.astype(np.float32))
    for include_ny in (False, True):
        got, want = tg.compact_arrays(ds, include_ny), jtg.compact_arrays(ds, include_ny)
        assert set(got) == set(want)
        for k in got:
            assert got[k].dtype == want[k].dtype
            npt.assert_array_equal(got[k], want[k])


def write_dataset(path, n_train, n_val, rng):
    """A seeded dataset in load_global_compact's layout, images as integer
    photon counts times alpha/255 (exact through the uint8 round trip)."""
    for part, n in (("train", n_train), ("val", n_val)):
        alpha = rng.uniform(180, 200, (n,)).astype(np.float32)
        a = alpha[:, None, None, None, None]
        counts = rng.integers(0, 256, (n, 2, H, H, 3)).astype(np.float32)
        bd = np.zeros((n, H, H), np.float32)
        bd[:, ::6, :] = rng.uniform(0.75, 1.18, (n, (H + 5) // 6, H))
        arrays = {"alphas": alpha,
                  "params_src": rng.normal(scale=0.3, size=(n, 2, L, 19)).astype(np.float32),
                  "images_gt": counts / 255.0 * a,
                  "boundary_distances": rng.integers(0, 20, (n, H, H)).astype(np.float32),
                  "boundary_depths": bd,
                  "images_ny": np.clip(np.round(counts / 255.0 * a
                                                + rng.normal(0, 2, counts.shape)), 0, 255)}
        for name, arr in arrays.items():
            np.save(path / f"{name}_{part}.npy", arr)


def trainer_args(tmp_path, data, **over):
    args = get_args("global_train", argv=[])
    args.img_size = [H, H]
    args.data_path = str(data)
    args.log_path = str(tmp_path / "logs")
    args.model_path = str(tmp_path / "weights")
    args.batch_size = 2
    args.epoch_num = 3
    args.dynamic_epoch = [2, 2, 4]   # the plateau gate opens at the last epoch
    for k, v in over.items():
        setattr(args, k, v)
    return args


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    path = tmp_path_factory.mktemp("data")
    write_dataset(path, 4, 2, np.random.default_rng(10))
    return path


def test_load_global_compact_round_trip(dataset):
    train = tg.load_global_compact(str(dataset), train=True, subset=3)
    val = tg.load_global_compact(str(dataset), train=False, include_ny=True)
    assert train["imgs_u8"].shape == (3, 2, H, H, 3) and "ny_u8" not in train
    alpha = np.load(dataset / "alphas_val.npy")
    img_gt = np.load(dataset / "images_gt_val.npy")
    close(val["imgs_u8"] / 255.0 * alpha[:, None, None, None, None], img_gt, rtol=1e-5, atol=1e-4)
    ours = tg.expand_compact_batch(tg.to_device_batch(val, "cpu"))
    close(ours["img_gt"], img_gt / alpha[:, None, None, None, None], rtol=1e-5, atol=1e-6)


def test_checkpoint_round_trip(tmp_path):
    model = GlobalStage(num_encoder_layers=1)
    path = checkpoint.save_checkpoint(str(tmp_path / "w" / "best"), model.state_dict())
    assert path.endswith("best.pth") and checkpoint.checkpoint_exists(str(tmp_path / "w" / "best"))
    other = GlobalStage(num_encoder_layers=1)
    other.load_state_dict(checkpoint.load_checkpoint(path))
    for a, b in zip(model.state_dict().values(), other.state_dict().values()):
        assert torch.equal(a, b)


def test_step_snapshot_round_trip(tmp_path):
    torch.manual_seed(0)
    model = GlobalStage(num_encoder_layers=1)
    opt = optim.make_optimizer(model.parameters(), 1e-3)
    model(torch.randn(1, 9, 38)).sum().backward()
    opt.step()
    sched = schedules.PlateauScheduler(lr=1e-3, factor=0.5, patience=1, min_lr=1e-4,
                                       best=0.25, num_bad=1)
    resume.save_step_snapshot(str(tmp_path / "last"), model, opt, sched, epoch=3, step=7,
                              loss_sum=1.5, loss_count=7, best_loss=0.2, best_epoch=2)
    model2 = GlobalStage(num_encoder_layers=1)
    opt2 = optim.make_optimizer(model2.parameters(), 1e-3)
    sched2, mid = resume.load_step_snapshot(str(tmp_path / "last"), model2, opt2)
    assert sched2 == sched
    assert mid == {"epoch": 3, "step": 7, "loss_sum": 1.5, "loss_count": 7,
                   "best_loss": 0.2, "best_epoch": 2}
    for a, b in zip(model.state_dict().values(), model2.state_dict().values()):
        assert torch.equal(a, b)
    s1, s2 = opt.state_dict()["state"], opt2.state_dict()["state"]
    for k in s1:
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(s1[k][name], s2[k][name])
    assert resume.load_step_snapshot(str(tmp_path / "none"), model2, opt2) is None
    checkpoint.save_checkpoint(str(tmp_path / "other"), {"params": 1})
    assert resume.load_step_snapshot(str(tmp_path / "other"), model2, opt2) is None


# ---------------------------------------------------------------- entry point


def test_run_global_training_on_cpu(tmp_path, dataset, capsys):
    args = trainer_args(tmp_path, dataset, attn_impl="flash")
    tg.run_global_training(args, device="cpu")
    w, logs = tmp_path / "weights", tmp_path / "logs"
    for f in ("best_run_exp_global_stage.pth", "last_exp_global_stage.pth", "done_global"):
        assert (w / f).exists(), f
    curve = np.load(logs / "loss_curve_exp_global_stage.npy")
    assert curve.shape == (3,) and np.isfinite(curve).all() and (curve > 0).all()
    steps = (logs / "global_steps.log").read_text().split("\n")
    losses = [float(s.split()[2]) for s in steps if s.strip()]
    assert len(losses) == 6 and np.isfinite(losses).all()
    best = checkpoint.load_checkpoint(str(w / "best_run_exp_global_stage"))
    assert set(best) == set(GlobalStage().state_dict())
    # a finished run resumes past its last epoch and trains no more
    tg.run_global_training(args, device="cpu")
    assert len((logs / "global_steps.log").read_text().split("\n")) == len(steps)
    assert "RESUMED at epoch 3 step 0" in capsys.readouterr().out


def test_resume_mid_epoch_reaches_the_same_weights(tmp_path, dataset, monkeypatch):
    """A run killed after its third step and resumed from the step snapshot
    ends with the weights of a run that was never stopped (CPU, dropout on:
    every mask is keyed by the epoch and the step)."""
    full = trainer_args(tmp_path / "full", dataset)
    tg.run_global_training(full, snapshot_every=1, device="cpu")

    make = tg.make_step_fns

    class Killed(Exception):
        pass

    def make_killable(*a, **kw):
        step, ev = make(*a, **kw)
        n = [0]

        def killable(*sa):
            n[0] += 1
            if n[0] == 4:
                raise Killed
            return step(*sa)

        return killable, ev

    cut = trainer_args(tmp_path / "cut", dataset)
    monkeypatch.setattr(tg, "make_step_fns", make_killable)
    with pytest.raises(Killed):
        tg.run_global_training(cut, snapshot_every=1, device="cpu")
    monkeypatch.setattr(tg, "make_step_fns", make)
    tg.run_global_training(cut, snapshot_every=1, device="cpu")
    a = checkpoint.load_checkpoint(f"{full.model_path}/last_exp_global_stage")
    b = checkpoint.load_checkpoint(f"{cut.model_path}/last_exp_global_stage")
    assert a["mid"] == b["mid"] and a["sched"] == b["sched"]
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    npt.assert_array_equal(np.load(f"{full.log_path}/loss_curve_exp_global_stage.npy"),
                           np.load(f"{cut.log_path}/loss_curve_exp_global_stage.npy"))


def test_cli_entry_and_device_default(tmp_path, dataset):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    args = trainer_args(tmp_path, dataset)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tg.run_global_training(args)
    argv = ["--cuda", "cpu", "--img_size", str(H), str(H), "--data_path", str(dataset),
            "--log_path", str(tmp_path / "logs"), "--model_path", str(tmp_path / "w"),
            "--batch_size", "2", "--epoch_num", "1", "--dynamic_epoch", "2", "2", "4",
            "--skip_val", "--w_variant"]
    cli.global_train_main(argv)
    assert (tmp_path / "w" / "best_run_exp_global_stage_w.pth").exists()
    assert (tmp_path / "w" / "done_global_w").exists()
    assert isinstance(get_args("global_train", argv=[]), argparse.Namespace)
    assert isinstance(get_args("local_train", argv=[]), argparse.Namespace)
    with pytest.raises(ValueError, match="unknown mode"):
        get_args("train_local", argv=[])
