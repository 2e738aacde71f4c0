"""The port's VOS + MOTS training step (unicorn_torch/core/train_step.py
`uni_mask_loss_fn`, `make_uni_mask_train_step`; losses/vos.py `vos_loss`;
exp/track_mask.py `get_optimizer`, `get_train_step`) against the JAX
package's, on the CPU.

The JAX mask-stage tests' Unicorn (tests/test_mask_stage.py:28: CSPDarknet
depth 0.33 width 0.25, "conv" interaction, no head attention) with 8
classes, the CondInst controllers and the RAFT up-mask at the exp's rate 4
(d_rate 2), fp32, on 64x64 frame pairs. Parameters come from the port's
seeded init and reach JAX through convert.to_flax. One batch of two pairs
(four track ids matched across the frames, one more than the three VOS
slots, and one track that leaves) runs as VOS + MOTS, VOS only and MOTS
only; a second batch feeds the accumulation. The JAX loss-and-gradient
function is compiled once for the module.

Tolerances, set before the first run at the uni step's
(tests/test_torch_port_train_step.py): the loss dict rtol 1e-4, atol 1e-6;
gradients leaf by leaf within 1e-3 of the leaf's largest magnitude; AdamW
from the same gradients rtol 1e-5, atol 1e-7; the whole step (the port's
own gradients): Adam's first update is about lr * sign(g), so every entry
within 2.01 lr of JAX's and the entries whose gradient is well determined
(at least 1e-2 of the leaf's largest) within 2e-2 lr. Frozen tensors are
compared bit for bit.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unicorn_torch.convert import from_flax, to_flax
from unicorn_torch.core.train_state import TrainState
from unicorn_torch.core.train_step import uni_mask_loss_fn
from unicorn_torch.exp.det_mask import mask_only_trainable
from unicorn_torch.exp.unicorn_track_tiny_mask import Exp as TExp
from unicorn_torch.models.unicorn import Unicorn as TUnicorn
from unicorn_tpu.core import train_state as jts
from unicorn_tpu.core.train_step import uni_mask_loss_fn as j_loss_fn
from unicorn_tpu.exp.track_mask import ExpTrackMask as JExp
from unicorn_tpu.models.unicorn import Unicorn as JUnicorn

H = W = 64
D_RATE, UP_RATE = 2, 4
CFG = dict(num_classes=8, backbone_name="csp_darknet", depth=0.33,
           width=0.25, in_channels=(256, 512, 1024), interact_mode="conv",
           n_layer_att=0, use_attention=False, use_mask=True, use_raft=True,
           up_rate=UP_RATE)
LOSS_KW = dict(mot_weight=3.0, bidirect=True, use_l1=True)
TASKS = {"vos+mots": (1, 2), "vos": (1, 1), "mots": (2, 2)}
# the exp's schedule with a first learning rate that is not 0
EXP_FIELDS = dict(warmup_lr=1e-3, input_size=(H, W))
ITERS_PER_EPOCH = 4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _batch(seed):
    """Two pairs: five instances in frame 0 (track ids 1-5), four of them
    in frame 1 in another order, drifting by a pixel; rectangle masks at
    the d_rate grid inside the boxes."""
    rng = np.random.RandomState(seed)
    images = (rng.rand(2, 2, H, W, 3) * 255).astype(np.float32)
    Hm, Wm = H // D_RATE, W // D_RATE
    targets = np.zeros((2, 2, 6, 6), np.float32)
    masks = np.zeros((2, 2, 6, Hm, Wm), np.float32)
    for b in range(2):
        y0 = rng.randint(0, Hm - 10, 5)
        x0 = rng.randint(0, Wm - 10, 5)
        hw = rng.randint(5, 10, (5, 2))
        cls = rng.randint(0, 8, 5)
        for f in range(2):
            order = np.arange(5) if f == 0 else np.array([3, 0, 4, 1])
            for row, i in enumerate(order):
                y, x = y0[i] + f, x0[i] + f
                h, w = hw[i]
                masks[b, f, row, y:y + h, x:x + w] = 1.0
                targets[b, f, row] = [cls[i], D_RATE * (x + w / 2),
                                      D_RATE * (y + h / 2), D_RATE * w,
                                      D_RATE * h, i + 1]
    return images, targets, masks


def _torch_batch(batch, tasks):
    images, targets, masks = batch
    return (torch.from_numpy(images).permute(0, 1, 4, 2, 3).contiguous(),
            torch.from_numpy(targets), torch.tensor(tasks),
            torch.from_numpy(masks))


def _leaves(tree):
    return {"/".join(str(p.key) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(1)
    tm = TUnicorn(**CFG, generator=torch.Generator().manual_seed(0))
    state = {k: v.clone() for k, v in tm.state_dict().items()}
    params = {"params": to_flax(state)}
    jm = JUnicorn(**CFG)

    @jax.jit
    def loss_fn(p, images, targets, tasks, masks):
        def loss(p_):
            return j_loss_fn(jm, p_, images, targets, tasks, masks, (H, W),
                             d_rate=D_RATE, up_rate=UP_RATE, **LOSS_KW)
        (_, d), g = jax.value_and_grad(loss, has_aux=True)(p)
        return d, g

    batches = [_batch(0), _batch(1)]
    jb = [tuple(map(jnp.asarray, b)) for b in batches]

    def run(p, i, tasks):
        images, targets, masks = jb[i]
        return loss_fn(p, images, targets, jnp.asarray(tasks, jnp.int32),
                       masks)

    jax_out = {name: run(params, 0, t) for name, t in TASKS.items()}
    jax_out["second"] = run(params, 1, TASKS["vos+mots"])
    return dict(state=state, params=params, batches=batches, run=run,
                jax_out=jax_out)


def _torch_model(setup, mask_only=False):
    m = TUnicorn(**CFG)
    m.load_state_dict(setup["state"])
    if mask_only:
        for n, p in m.named_parameters():
            p.requires_grad_(mask_only_trainable([(n, p)])[n])
    return m.train()


def _torch_loss_and_grads(setup, tasks, mask_only):
    model = _torch_model(setup, mask_only)
    total, loss_dict = uni_mask_loss_fn(
        model, *_torch_batch(setup["batches"][0], TASKS[tasks]), (H, W),
        up_rate=UP_RATE, **LOSS_KW)
    total.backward()
    return model, {k: v.item() for k, v in loss_dict.items()}


@pytest.mark.parametrize("tasks", list(TASKS))
def test_uni_mask_loss_dict_matches_jax(setup, tasks):
    _, got = _torch_loss_and_grads(setup, tasks, False)
    ref = {k: float(v) for k, v in setup["jax_out"][tasks][0].items()}
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-6, err_msg=k)
    if "vos" in tasks:
        assert got["condinst_loss_vos"] > 0 and got["corr_loss_vos"] > 0
    if "mots" in tasks:
        assert got["condinst_loss_mots"] > 0 and got["corr_loss_mots"] > 0


@pytest.mark.parametrize("mask_only", [True, False])
@pytest.mark.parametrize("tasks", list(TASKS))
def test_uni_mask_gradients_match_jax_leaf_by_leaf(setup, tasks, mask_only):
    """mask_only: only the controllers and the mask branch get a gradient;
    else every tensor (the embeddings through the correlation's backward
    too), against JAX's."""
    model, _ = _torch_loss_and_grads(setup, tasks, mask_only)
    grads = {}
    for n, p in model.named_parameters():
        if mask_only and not p.requires_grad:
            assert p.grad is None, n
            continue
        grads[n] = p.grad if p.grad is not None else torch.zeros_like(p)
    got = _leaves(to_flax(grads))
    ref = _leaves(setup["jax_out"][tasks][1]["params"])
    assert set(got) <= set(ref) and (mask_only or set(got) == set(ref))
    bad = {}
    for path, g in got.items():
        scale = max(np.abs(ref[path]).max(), 1e-12)
        worst = np.abs(g - ref[path]).max() / scale
        if worst > 1e-3:
            bad[path] = worst
    assert not bad, bad
    assert sum(np.abs(g).max() > 0 for g in got.values()) > 0.5 * len(got)
    if not mask_only and "vos" in tasks:
        assert np.abs(got["upsample/Conv_1/kernel"]).max() > 0


def _exps():
    te, je = TExp(), JExp()
    for e in (te, je):
        for k, v in EXP_FIELDS.items():
            setattr(e, k, v)
    return te, je


def test_exp_fields_and_factories_match_jax():
    te, je = TExp(), JExp()
    for field in ("use_raft", "d_rate", "up_rate", "ema", "train_mask_only",
                  "max_epoch", "mhs", "weight_decay", "always_l1",
                  "use_grad_acc", "grad_acc_step", "mot_weight",
                  "scale_all_mot", "bidirect", "input_size", "num_classes",
                  "basic_lr_per_img", "warmup_epochs", "min_lr_ratio"):
        assert getattr(te, field) == getattr(je, field), field
    tx = te.get_optimizer(16, 100)
    assert (tx.kind, tx.weight_decay, tx.grad_accum) == ("adamw", 5e-4, 2)
    assert tx.trainable_mask_fn is mask_only_trainable
    te.train_mask_only = False
    assert te.get_optimizer(16, 100).trainable_mask_fn is None


@jax.jit
def _apply(js, grads):
    """optax's update, compiled: eager it dispatches thousands of ops."""
    return js.apply_gradients(grads)


def test_trainable_set_is_jax_frozen_rule(setup):
    """The tensors JAX's ExpTrackMask optimizer moves (two micro-steps of
    ones) are the tensors mask_only_trainable marks on torch names."""
    params = setup["params"]
    ones = jax.tree_util.tree_map(jnp.ones_like, params)
    js = jts.TrainState.create(params, _jax_tx(True), use_ema=False)
    after = _leaves(_apply(_apply(js, ones), ones).params)
    moves = {k.removeprefix("params/"): bool((v != after[k]).any())
             for k, v in _leaves(params).items()}
    model = _torch_model(setup)
    trains = mask_only_trainable(model.named_parameters())
    got = _leaves(to_flax({n: torch.full_like(p, float(trains[n]))
                           for n, p in model.named_parameters()}))
    assert set(got) == set(moves)
    for path, m in moves.items():
        assert got[path].min() == got[path].max() == float(m), path
    assert 0 < sum(moves.values()) < len(moves)
    assert moves["mask_branch/up_mask_conv2/kernel"]
    assert not moves["upsample/Conv_1/kernel"]


@functools.lru_cache(maxsize=None)
def _jax_tx(mask_only):
    """The JAX exp's rule, one object per setting, so that `_apply`
    compiles once for each."""
    je = _exps()[1]
    je.train_mask_only = mask_only
    return je.get_optimizer(2, ITERS_PER_EPOCH)


def _states(setup, mask_only=True):
    te = _exps()[0]
    te.train_mask_only = mask_only
    js = jts.TrainState.create(setup["params"], _jax_tx(mask_only),
                               use_ema=False)
    ts_ = TrainState.create(_torch_model(setup),
                            te.get_optimizer(2, ITERS_PER_EPOCH),
                            use_ema=te.ema, device="cpu")
    assert ts_.ema_model is None and ts_.tx.grad_accum == 2
    return te, js, ts_



def _snapshot(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _assert_frozen(model, start):
    trains = mask_only_trainable(model.named_parameters())
    for n, p in model.named_parameters():
        assert p.requires_grad == trains[n], n
        if not trains[n]:
            assert torch.equal(p, start[n]), n


def test_adamw_mask_only_accumulation_from_same_gradients(setup):
    """Four micro-steps (two updates, each from the mean of two gradients)
    of the exps' AdamW rules from JAX's gradients: parameters match optax's
    after every micro-step, nothing moves on the first, the frozen tensors
    never, every trainable one with a gradient on the second."""
    _, js, ts_ = _states(setup)
    start = _snapshot(ts_.model)
    order = ("vos+mots", "vos", "mots", "second")
    for i, name in enumerate(order):
        grads = setup["jax_out"][name][1]
        js = _apply(js, grads)
        state = from_flax(grads["params"])
        for n, p in ts_.model.named_parameters():
            if p.requires_grad:
                p.grad = state[n].clone()
        ts_.apply_gradients()
        got = _leaves(to_flax(dict(ts_.model.named_parameters())))
        for path, v in _leaves(js.params["params"]).items():
            np.testing.assert_allclose(got[path], v, rtol=1e-5, atol=1e-7,
                                       err_msg=f"micro-step {i} {path}")
        if i == 0:
            assert all(torch.equal(p, start[n])
                       for n, p in ts_.model.named_parameters())
        if i == 1:
            g0 = _leaves(setup["jax_out"][order[0]][1]["params"])
            g1 = _leaves(grads["params"])
            has_grad = {path for path in g0
                        if np.abs(g0[path]).max() + np.abs(g1[path]).max() > 0}
            moved = _leaves(to_flax({
                n: torch.full_like(p, float(not torch.equal(p, start[n])))
                for n, p in ts_.model.named_parameters()}))
            trains = _leaves(to_flax({
                n: torch.full_like(p, float(p.requires_grad))
                for n, p in ts_.model.named_parameters()}))
            for path in has_grad:
                assert moved[path].max() == trains[path].max(), path
    _assert_frozen(ts_.model, start)
    assert ts_.step == int(js.step) == 4 and ts_.opt_count == 2


@pytest.mark.parametrize("mask_only", [True, False])
def test_whole_step_with_accumulation_matches_jax(setup, mask_only):
    """The exp's train step on the mixed batch, then on the second one:
    one AdamW update from the mean of the two gradients, both taken at the
    starting parameters (so JAX's precomputed ones apply)."""
    te, js, ts_ = _states(setup, mask_only)
    step = te.get_train_step(2)
    start = _snapshot(ts_.model)
    for i, name in enumerate(("vos+mots", "second")):
        _, loss_dict = step(ts_, *_torch_batch(setup["batches"][i],
                                               TASKS["vos+mots"]))
        np.testing.assert_allclose(
            loss_dict["total_loss"].item(),
            float(setup["jax_out"][name][0]["total_loss"]), rtol=1e-4)
        js = _apply(js, setup["jax_out"][name][1])
    mean = jax.tree_util.tree_map(lambda a, b: 0.5 * (a + b),
                                  setup["jax_out"]["vos+mots"][1],
                                  setup["jax_out"]["second"][1])
    lr = te.get_lr_fn(2, ITERS_PER_EPOCH)(0)
    got = _leaves(to_flax(dict(ts_.model.named_parameters())))
    grads = _leaves(mean["params"])
    for path, v in _leaves(js.params["params"]).items():
        d = np.abs(got[path] - v)
        assert d.max() <= 2.01 * lr, (path, d.max())
        g = np.abs(grads[path])
        sure = g >= 1e-2 * max(g.max(), 1e-30)
        if sure.any():
            assert d[sure].max() <= 2e-2 * lr + 1e-6 * np.abs(v[sure]).max(), \
                (path, d[sure].max())
    if mask_only:
        _assert_frozen(ts_.model, start)
    else:
        assert all(p.requires_grad for p in ts_.model.parameters())
    assert ts_.step == 2 and ts_.opt_count == 1
