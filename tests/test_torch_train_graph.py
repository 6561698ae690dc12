"""The global training step on static buffers, the form a CUDA graph holds
(``train/global_.py``: ``TrainStep``, ``StaticStep``), and what it needs:
dropout masks drawn ahead, a learning rate the graph reads from the device,
Sobel constants built once. No JAX.

On the CPU, ``StaticStep`` runs the step's core eagerly, as a capture
records it: the batch and the loss weights copied into buffers of fixed
address, every dropout mask drawn ahead into a buffer of its own. Its
losses, gradients and parameters equal the eager step's bit for bit, step
after step. Tests marked ``cuda`` hold the captured and replayed step to
the eager one on a card (run there with
``python -m pytest --noconftest -m cuda tests/test_torch_train_graph.py``).
"""

import copy

import numpy as np
import pytest
import torch

from blurry_edges_tpu_torch.config import CamConfig, GridConfig, PatchConfig
from blurry_edges_tpu_torch.models.global_stage import GlobalStage, keyed_dropout
from blurry_edges_tpu_torch.ops import sobel
from blurry_edges_tpu_torch.ops.dfd import DfDSolver
from blurry_edges_tpu_torch.train import global_ as tg
from blurry_edges_tpu_torch.train import optim
from blurry_edges_tpu_torch.train.resume import portable_state
from blurry_edges_tpu_torch.utils import trace
from blurry_edges_tpu_torch.utils.seeding import fold_in, generator

torch.set_num_threads(1)

PATCH, CAM = PatchConfig(), CamConfig()
DFD = DfDSolver.from_config(CAM, PATCH)
LR, DROPOUT = 1e-4, 0.1
GAMMAS = [0.1, 0.05, 0.02, 0.002, 0.002, 0.0001, 0.5]
SEEDS = [fold_in(fold_in(2**31 + 77, 0), b) for b in range(3)]


def fresh_model(attn_impl, n_layers, device="cpu"):
    """A GlobalStage with dropout from the trainer's seeded init, its output
    layer at 1/4 (the loss's well-conditioned range)."""
    model = GlobalStage(num_encoder_layers=n_layers, dropout=DROPOUT, attn_impl=attn_impl)
    optim.xavier_reinit(model, torch.Generator().manual_seed(1898))
    with torch.no_grad():
        model.generator.weight.mul_(0.25)
    return model.to(device)


def compact_batch(rng, B, H, device="cpu"):
    """A batch in the trainer's compact layout (``to_device_batch``)."""
    L = GridConfig(H=H, W=H).num_tokens
    bd = np.zeros((B, H, H), np.float32)
    bd[:, ::5, :] = rng.uniform(0.75, 1.18, (B, (H + 4) // 5, H))
    arrays = {"input_param": rng.normal(scale=0.3, size=(B, 2, L, 19)).astype(np.float32),
              "imgs_u8": rng.integers(0, 256, (B, 2, H, H, 3)).astype(np.uint8),
              "bndry_dist": rng.integers(0, 10, (B, H, H)).astype(np.uint16),
              "bndry_depth": bd}
    return tg.to_device_batch(arrays, device)


def step_fns(model, opt, H, chunks):
    return tg.make_step_fns(model, opt, PATCH, GridConfig(H=H, W=H), DFD, chunks)


def grads(model):
    return [p.grad.clone() for p in model.parameters()]


def assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
@pytest.mark.parametrize("grad_accum", [4, 1])
def test_static_step_equals_the_eager_step(grad_accum, attn_impl):
    """Three steps, three seeds, a new batch each: the losses, gradients and
    parameters of the static-buffer core equal the eager step's."""
    H, B = 41, 4
    rng = np.random.default_rng(3)
    batches = [compact_batch(rng, B, H) for _ in SEEDS]
    gammas = torch.tensor(GAMMAS)
    eager_model = fresh_model(attn_impl, 2)
    static_model = copy.deepcopy(eager_model)
    eager, _ = step_fns(eager_model, optim.make_optimizer(eager_model.parameters(), LR), H,
                        grad_accum)
    core, _ = step_fns(static_model, optim.make_optimizer(static_model.parameters(), LR), H,
                       grad_accum)
    st = core.static(batches[0], gammas)
    for batch, seed in zip(batches, SEEDS):
        want = eager(batch, gammas, seed)
        st.load(batch, gammas, seed)
        got = st.run()
        assert torch.equal(got, want)
        assert_same(grads(static_model), grads(eager_model))
        assert_same(list(static_model.parameters()), list(eager_model.parameters()))
    # the step moved the parameters
    start = fresh_model(attn_impl, 2)
    assert not torch.equal(next(static_model.parameters()), next(start.parameters()))


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_predrawn_masks_are_keyed_dropouts_draws(attn_impl):
    """Every mask the step draws is drawn ahead, from its own seed, as
    ``keyed_dropout`` draws it; another step seed draws other masks."""
    H, B, chunks, layers = 41, 4, 2, 2
    L = GridConfig(H=H, W=H).num_tokens
    model = fresh_model(attn_impl, layers)
    step, _ = step_fns(model, optim.make_optimizer(model.parameters(), LR), H, chunks)
    batch, gammas = compact_batch(np.random.default_rng(4), B, H), torch.tensor(GAMMAS)
    st = step.static(batch, gammas)
    st.load(batch, gammas, SEEDS[0])
    sites = st.draws(SEEDS[0])
    per_layer = 4 if attn_impl == "xla" else 3     # flash drops no attention probabilities
    assert len(sites) == len(st.masks) == chunks * layers * per_layer
    for s, shape in sites:
        u = st.masks[s]
        assert tuple(u.shape) == shape
        assert torch.equal(u, torch.rand(shape, generator=generator(s, "cpu")))
        x = torch.randn((B // chunks, 8, L, L) if len(shape) == 4 else shape)
        assert torch.equal(keyed_dropout(x, DROPOUT, s, shape, masks=st.masks),
                           keyed_dropout(x, DROPOUT, s, shape))
    first = {s: u.clone() for s, u in st.masks.items()}
    st.load(batch, gammas, SEEDS[1])
    assert not set(first) & set(st.masks)
    for u0, u1 in zip(first.values(), st.masks.values()):
        assert not torch.equal(u0, u1)


def test_a_missing_or_misshapen_mask_raises():
    x = torch.ones(2, 3)
    with pytest.raises(KeyError):
        keyed_dropout(x, DROPOUT, 5, masks={6: torch.zeros(2, 3)})
    with pytest.raises(ValueError):
        keyed_dropout(x, DROPOUT, 5, masks={5: torch.zeros(3, 2)})


def test_set_lr_writes_a_tensor_rate_in_place():
    model = torch.nn.Linear(3, 2)
    opt = optim.make_optimizer(model.parameters(), 1e-3)
    optim.set_lr(opt, 5e-4)
    assert opt.param_groups[0]["lr"] == 5e-4 == optim.current_lr(opt)
    optim.make_capturable(opt)
    lr = opt.param_groups[0]["lr"]
    assert isinstance(lr, torch.Tensor) and lr.dim() == 0 and lr.dtype == torch.float32
    assert opt.param_groups[0]["capturable"]
    optim.set_lr(opt, 2.5e-4)
    assert opt.param_groups[0]["lr"] is lr
    assert optim.current_lr(opt) == float(np.float32(2.5e-4))
    optim.make_capturable(opt)
    assert opt.param_groups[0]["lr"] is lr


def test_make_capturable_keeps_a_resumed_state_and_snapshots_stay_portable():
    model = torch.nn.Linear(3, 2)
    opt = optim.make_optimizer(model.parameters(), 1e-3)
    model(torch.ones(1, 3)).sum().backward()
    opt.step()
    saved = copy.deepcopy(opt.state_dict())
    optim.make_capturable(opt)
    for p in model.parameters():
        step = opt.state[p]["step"]
        assert step.dtype == torch.float32 and step.device == p.device and float(step) == 1.0
    state = portable_state(opt)
    assert state["param_groups"][0]["lr"] == float(np.float32(1e-3))
    assert state["param_groups"][0]["capturable"] is False
    assert isinstance(opt.param_groups[0]["lr"], torch.Tensor)
    fresh = optim.make_optimizer(torch.nn.Linear(3, 2).parameters(), 1.0)
    fresh.load_state_dict(state)
    assert fresh.param_groups[0]["lr"] == pytest.approx(saved["param_groups"][0]["lr"])


@pytest.mark.parametrize("C", [1, 3])
def test_sobel_constants_are_the_old_ones_built_once(C):
    cpu = torch.device("cpu")
    k = sobel._sobel_kernel(C, torch.float32, cpu)
    old = torch.tensor((sobel._SOBEL_X, sobel._SOBEL_Y), dtype=torch.float32)[:, None]
    assert torch.equal(k, old.repeat(C, 1, 1, 1))
    assert sobel._sobel_kernel(C, torch.float32, cpu) is k
    for R in (5, 21):
        mats = sobel._sobel_flat_device(R, torch.float32, cpu)
        for m, want in zip(mats, sobel._sobel_flat_matrices(R)):
            assert torch.equal(m, torch.from_numpy(want))
        assert sobel._sobel_flat_device(R, torch.float32, cpu) is mats
    img = torch.rand(2, 9, 9, C)
    with torch.inference_mode():
        a = sobel.image_derivative(img)
    assert torch.equal(a, sobel.image_derivative(img))


# ------------------------------------------------------------------ card


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


# (attention, image size, batch, chunks): the benchmark's step at full width,
# and the materialised attention with its probability masks at 41x41
CARD_CASES = [("flash", 147, 8, 4), ("xla", 41, 4, 2)]


def card_run(dev, attn_impl, H, chunks, batches, graphed, lr_at=None):
    """Losses and final parameters of steps on ``batches`` (the seeds in
    turn), graphed or eager, both with the capturable optimizer;
    ``lr_at``: the step before which the rate is halved."""
    model = fresh_model(attn_impl, 8, dev)
    opt = optim.make_optimizer(model.parameters(), LR)
    optim.make_capturable(opt)
    step, _ = step_fns(model, opt, H, chunks)
    fn = step if graphed else step.eager
    gammas = torch.tensor(GAMMAS, device=dev)
    losses = []
    for k, batch in enumerate(batches):
        if k == lr_at:
            optim.set_lr(opt, LR / 2)
        losses.append(float(fn(batch, gammas, fold_in(7, k))))
    params = [p.detach().clone() for p in model.parameters()]
    return losses, params, step


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES, ids=[c[0] for c in CARD_CASES])
def test_graphed_step_equals_eager_on_the_card(dev, case):
    """Five steps, a seed each: the replayed graph's losses and parameters
    equal the eager step's bit for bit; halving the rate between replays
    changes the replayed update as it changes the eager one."""
    attn_impl, H, B, chunks = case
    rng = np.random.default_rng(5)
    batches = [compact_batch(rng, B, H, dev) for _ in range(5)]
    l_eager, p_eager, _ = card_run(dev, attn_impl, H, chunks, batches, graphed=False)
    l_graph, p_graph, step = card_run(dev, attn_impl, H, chunks, batches, graphed=True)
    assert [st.graph is not None for st in step.steps.values()] == [True]
    assert l_graph == l_eager
    assert_same(p_graph, p_eager)
    l_half, p_half, _ = card_run(dev, attn_impl, H, chunks, batches, graphed=True, lr_at=3)
    l_half_eager, p_half_eager, _ = card_run(dev, attn_impl, H, chunks, batches,
                                             graphed=False, lr_at=3)
    assert l_half == l_half_eager and l_half[:4] == l_graph[:4]
    assert_same(p_half, p_half_eager)
    assert not all(torch.equal(a, b) for a, b in zip(p_half, p_graph))


@pytest.mark.cuda
def test_each_signature_replays_its_own_graph(dev):
    """Batches of two shapes in turn: each shape is captured on its own and
    the steps equal the eager ones; a shape first met under a profiler runs
    eagerly, and a captured one replays there in the span ``graph_replay``."""
    H, chunks = 41, 2
    rng = np.random.default_rng(6)
    a, b = (compact_batch(rng, n, H, dev) for n in (4, 2))
    order = [a, a, b, a, b, b, a]
    l_eager, p_eager, _ = card_run(dev, "xla", H, chunks, order, graphed=False)
    l_graph, p_graph, step = card_run(dev, "xla", H, chunks, order, graphed=True)
    assert sorted(st.batch["input_param"].shape[0] for st in step.steps.values()) == [2, 4]
    assert all(st.graph is not None for st in step.steps.values())
    assert l_graph == l_eager
    assert_same(p_graph, p_eager)

    from torch.profiler import ProfilerActivity, profile
    c = compact_batch(rng, 6, H, dev)
    gammas = torch.tensor(GAMMAS, device=dev)
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        step(a, gammas, 11)
        step(c, gammas, 12)           # new: its warm-up
        step(c, gammas, 13)           # not captured under the profiler
    s = trace.summary()
    trace.reset()
    assert s["train_step"]["calls"] == 3 and s["graph_replay"]["calls"] == 1
    assert step.steps[tg._signature(c, gammas)].graph is None
    step(c, gammas, 14)
    assert step.steps[tg._signature(c, gammas)].graph is not None
