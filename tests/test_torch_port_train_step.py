"""The port's uni-stage training step (unicorn_torch/core) against the JAX
package's `uni_loss_fn` / `TrainState.apply_gradients`, on the CPU.

A ConvNeXt-Tiny Unicorn with the PAFPN and head at width 0.5, one attention
block per level, fp32, on 96x160 frame pairs; one SOT and one MOT sample per
batch, mhs on, the experiment's loss weights (mot_weight 3, l1 always on).
The JAX loss-and-gradient function is compiled once for the module and fed
two batches.

Tolerances.
  * loss dict: rtol 1e-4 (the model's activations agree to 1e-4, see
    test_torch_port_model.py).
  * gradients, leaf by leaf through convert.to_flax: every entry within 1e-3
    of the leaf's largest magnitude.
  * AdamW and SGD from the SAME gradients: parameters rtol 1e-5, atol 1e-7
    after one and after three updates.
  * the whole step (the port's own gradients): Adam divides a gradient by
    its own magnitude, so the first updates are lr * sign(g) and an entry
    whose gradient is noise may move the other way. Every entry stays
    within 2.01 lr per update of the JAX package's; the entries whose
    gradient is well determined (at least 1e-2 of the leaf's largest)
    within 2e-2 lr. The same for the EMA.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unicorn_torch.convert import from_flax, to_flax
from unicorn_torch.core import train_state as tts
from unicorn_torch.core.train_step import (make_det_train_step,
                                           make_uni_train_step, uni_loss_fn)
from unicorn_torch.exp.unicorn_track_tiny import Exp as TExp
from unicorn_torch.models.unicorn import Unicorn as TUnicorn
from unicorn_torch.models.unicorn import YOLOXDet as TDet
from unicorn_tpu.core import train_state as jts
from unicorn_tpu.core.train_step import uni_loss_fn as j_uni_loss_fn
from unicorn_tpu.exp.track import ExpTrack as JExp
from unicorn_tpu.models.unicorn import Unicorn as JUnicorn

H, W = 96, 160
CFG = dict(num_classes=8, backbone_name="convnext_tiny", width=0.5,
           n_layer_att=1)
LOSS_KW = dict(mot_weight=3.0, sot_weight=1.0, bidirect=True, use_l1=True,
               num_classes=8, mhs=True, mhs_weight=0.5)
WD = 5e-4


def lr_fn(count):
    """Grows with the iteration, so a wrong count shows."""
    return 1e-3 * (1.0 + count)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _batch(seed, tasks):
    rng = np.random.RandomState(seed)
    images = (rng.rand(2, 2, H, W, 3) * 255).astype(np.float32)
    targets = np.zeros((2, 2, 6, 6), np.float32)
    for b in range(2):
        n = 1 if tasks[b] == 1 else 4
        cxy = rng.uniform(0.2, 0.8, (n, 2)) * [W, H]
        wh = rng.uniform(16, 56, (n, 2))
        for f in range(2):
            targets[b, f, :n, 0] = rng.randint(0, 8, n) if tasks[b] == 2 else 0
            targets[b, f, :n, 1:3] = cxy + f * rng.uniform(-3, 3, (n, 2))
            targets[b, f, :n, 3:5] = wh
            targets[b, f, :n, 5] = np.arange(1, n + 1)
        if tasks[b] == 2:
            targets[b, 1, :n, 5] = np.roll(targets[b, 1, :n, 5], 1)
    return images, targets, np.asarray(tasks, np.int32)


def _torch_batch(batch):
    images, targets, tasks = batch
    return (torch.from_numpy(images).permute(0, 1, 4, 2, 3).contiguous(),
            torch.from_numpy(targets), torch.from_numpy(tasks).long())


def _torch_model(state):
    m = TUnicorn(**CFG)
    m.load_state_dict(state)
    return m.train()


def _leaves(tree):
    return {"/".join(str(p.key) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(1)
    batches = [_batch(0, (1, 2)), _batch(1, (2, 1))]
    jm = JUnicorn(**CFG)
    init = jax.jit(functools.partial(jm.init, method=JUnicorn.init_all))
    params = init(jax.random.PRNGKey(3), jnp.asarray(batches[0][0][:, 0]))
    # zero-initialised kernels (offsets, attention logits) would hide their
    # inputs' gradients: give every leaf of the interaction a small value
    rng = np.random.RandomState(9)
    params = jax.tree_util.tree_map(np.asarray, params)
    layer = params["params"]["interaction"]["layer0"]
    for name, s in (("sampling_offsets", 0.05), ("attention_weights", 0.5)):
        k = layer[name]["kernel"]
        layer[name]["kernel"] = (s * rng.randn(*k.shape)).astype(np.float32)
    params = jax.tree_util.tree_map(jnp.asarray, params)

    @jax.jit
    def loss_and_grads(p, images, targets, tasks):
        def loss(p_):
            return j_uni_loss_fn(jm, p_, images, targets, tasks, (H, W),
                                 *LOSS_KW.values())
        (_, loss_dict), grads = jax.value_and_grad(loss, has_aux=True)(p)
        return loss_dict, grads

    jax_out = [loss_and_grads(params, *map(jnp.asarray, b)) for b in batches]
    state = from_flax(params)
    return dict(batches=batches, params=params, state=state, jax_out=jax_out)


def _torch_loss_and_grads(setup, i):
    model = _torch_model(setup["state"])
    total, loss_dict = uni_loss_fn(model, *_torch_batch(setup["batches"][i]),
                                   (H, W), **LOSS_KW)
    total.backward()
    return model, loss_dict, {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("i", [0, 1])
def test_uni_loss_dict_matches_jax(setup, i):
    _, loss_dict, _ = _torch_loss_and_grads(setup, i)
    ref = setup["jax_out"][i][0]
    assert set(loss_dict) == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(loss_dict[k].item(), float(v), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    assert float(ref["mhs_loss"]) > 0 and float(ref["corr_loss_mot"]) > 0


@pytest.mark.parametrize("i", [0, 1])
def test_uni_gradients_match_jax_leaf_by_leaf(setup, i):
    _, _, grads = _torch_loss_and_grads(setup, i)
    assert all(g is not None for g in grads.values())
    got = _leaves(to_flax(grads))
    ref = _leaves(setup["jax_out"][i][1]["params"])
    assert set(got) == set(ref)
    worst = {}
    for path, g_ref in ref.items():
        assert got[path].shape == g_ref.shape, path
        scale = np.abs(g_ref).max()
        worst[path] = np.abs(got[path] - g_ref).max() / max(scale, 1e-12)
    bad = {p: w for p, w in worst.items() if w > 1e-3}
    assert not bad, bad
    # every leaf but the unused class towers' sees a gradient
    assert sum(np.abs(g).max() > 0 for g in ref.values()) > 0.9 * len(ref)


def test_to_flax_inverts_from_flax(setup):
    back = _leaves(to_flax(setup["state"]))
    ref = _leaves(setup["params"]["params"])
    assert set(back) == set(ref)
    for path, v in ref.items():
        np.testing.assert_array_equal(back[path], v, err_msg=path)
    with pytest.raises(KeyError, match="no rule"):
        to_flax({"head.nonsense.weight": torch.zeros(1)})


def test_decay_mask_partitions_as_flax_ndim(setup):
    """default_wd_mask on torch shapes against `p.ndim > 1` on flax shapes,
    through the bridge's name map (the head's beta_k are (1, C, 1, 1) here
    and (C,) there; a 1x1 conv to one channel is (1, I, 1, 1) here)."""
    model = _torch_model(setup["state"])
    named = list(model.named_parameters())
    mask = tts.default_wd_mask(named)
    as_tensors = {n: torch.full_like(p, float(mask[n])) for n, p in named}
    got = _leaves(to_flax(as_tensors))
    ref = _leaves(jts.default_wd_mask(setup["params"]["params"]))
    assert set(got) == set(ref)
    for path, decays in ref.items():
        assert bool(got[path].all()) == bool(decays), path
        assert got[path].min() == got[path].max(), path
    assert not mask["head.beta_0"] and mask["head.obj_preds.0.weight"]


def _jax_state(setup, kind, grad_accum):
    tx = jts.make_optimizer(lr_fn, kind=kind, weight_decay=WD,
                            grad_accum=grad_accum,
                            no_decay_mask_fn=jts.default_wd_mask)
    return jts.TrainState.create(setup["params"], tx)


def _torch_state(setup, kind, grad_accum):
    tx = tts.make_optimizer(lr_fn, kind=kind, weight_decay=WD,
                            grad_accum=grad_accum,
                            no_decay_mask_fn=tts.default_wd_mask)
    return tts.TrainState.create(_torch_model(setup["state"]), tx,
                                 device="cpu")


def _set_grads(model, jax_grads):
    state = from_flax(jax_grads)
    for n, p in model.named_parameters():
        p.grad = state[n].clone()


def _assert_params_close(model, jax_params, rtol, atol, what):
    got = _leaves(to_flax(dict(model.named_parameters())))
    for path, v in _leaves(jax_params["params"]).items():
        np.testing.assert_allclose(got[path], v, rtol=rtol, atol=atol,
                                   err_msg=f"{what} {path}")


@pytest.mark.parametrize("kind", ["adamw", "sgd"])
def test_optimizer_matches_optax_from_same_gradients(setup, kind):
    """One and three updates, alternating the two batches' JAX gradients."""
    js, ts_ = _jax_state(setup, kind, 1), _torch_state(setup, kind, 1)
    for n in range(3):
        grads = setup["jax_out"][n % 2][1]
        js = js.apply_gradients(grads)
        _set_grads(ts_.model, grads)
        ts_.apply_gradients()
        if n in (0, 2):
            _assert_params_close(ts_.model, js.params, 1e-5, 1e-7,
                                 f"{kind} update {n + 1}")
            _assert_params_close(ts_.ema_model, js.ema_params, 1e-5, 1e-7,
                                 f"{kind} ema {n + 1}")
    assert ts_.step == int(js.step) == 3 and ts_.opt_count == 3


def test_grad_accum_and_ema_match_optax_from_same_gradients(setup):
    """grad_accum 2: four micro-steps are two updates from the mean of two
    gradients each, the second at lr_fn(2); step and EMA advance on every
    micro-step, also where the parameters stand still."""
    js, ts_ = _jax_state(setup, "adamw", 2), _torch_state(setup, "adamw", 2)
    start = [p.detach().clone() for p in ts_.model.parameters()]
    for n in range(4):
        grads = setup["jax_out"][n % 2][1]
        js = js.apply_gradients(grads)
        _set_grads(ts_.model, grads)
        ts_.apply_gradients()
        if n == 0:       # a micro-step without an update
            assert all(torch.equal(p, s)
                       for p, s in zip(ts_.model.parameters(), start))
            assert ts_.step == 1 and ts_.opt_count == 0
        _assert_params_close(ts_.model, js.params, 1e-5, 1e-7, f"micro {n}")
        _assert_params_close(ts_.ema_model, js.ema_params, 1e-5, 1e-7,
                             f"ema micro {n}")
    assert ts_.step == int(js.step) == 4 and ts_.opt_count == 2
    assert ts_.lr() == lr_fn(4)
    assert all(p.grad is None for p in ts_.model.parameters())


def test_max_grad_norm_matches_optax(setup):
    tx_j = jts.make_optimizer(lr_fn, kind="sgd", weight_decay=0.0,
                              max_grad_norm=0.5)
    tx_t = tts.make_optimizer(lr_fn, kind="sgd", weight_decay=0.0,
                              max_grad_norm=0.5)
    js = jts.TrainState.create(setup["params"], tx_j, use_ema=False)
    ts_ = tts.TrainState.create(_torch_model(setup["state"]), tx_t,
                                use_ema=False, device="cpu")
    grads = setup["jax_out"][0][1]
    js = js.apply_gradients(grads)
    _set_grads(ts_.model, grads)
    ts_.apply_gradients()
    assert ts_.ema_model is None
    _assert_params_close(ts_.model, js.params, 1e-5, 1e-7, "clipped sgd")


def _assert_step_close(model, jax_params, jax_grads, lr_sum, what):
    """The whole-step bound of the module docstring."""
    got = _leaves(to_flax(dict(model.named_parameters())))
    grads = _leaves(jax_grads["params"])
    for path, v in _leaves(jax_params["params"]).items():
        d = np.abs(got[path] - v)
        assert d.max() <= 2.01 * lr_sum, (what, path, d.max())
        g = np.abs(grads[path])
        sure = g >= 1e-2 * max(g.max(), 1e-30)
        if sure.any():
            assert d[sure].max() <= 2e-2 * lr_sum + 1e-6 * np.abs(v[sure]).max(), \
                (what, path, d[sure].max())


def test_whole_step_matches_jax_after_one_adamw_update(setup):
    js, ts_ = _jax_state(setup, "adamw", 1), _torch_state(setup, "adamw", 1)
    step = make_uni_train_step((H, W), **LOSS_KW)
    _, loss_dict = step(ts_, *_torch_batch(setup["batches"][0]))
    ref_dict, grads = setup["jax_out"][0]
    js = js.apply_gradients(grads)
    np.testing.assert_allclose(loss_dict["total_loss"].item(),
                               float(ref_dict["total_loss"]), rtol=1e-4)
    assert not loss_dict["total_loss"].requires_grad
    _assert_step_close(ts_.model, js.params, grads, lr_fn(0), "params")
    _assert_step_close(ts_.ema_model, js.ema_params, grads, lr_fn(0), "ema")


def test_whole_step_matches_jax_after_two_micro_steps(setup):
    """grad_accum 2 on two different batches: one update from the mean of
    the two gradients. The second batch's gradient is taken at unchanged
    parameters on both sides, so the precomputed JAX gradients apply."""
    js, ts_ = _jax_state(setup, "adamw", 2), _torch_state(setup, "adamw", 2)
    step = make_uni_train_step((H, W), **LOSS_KW)
    for i in range(2):
        step(ts_, *_torch_batch(setup["batches"][i]))
        js = js.apply_gradients(setup["jax_out"][i][1])
    mean = jax.tree_util.tree_map(lambda a, b: 0.5 * (a + b),
                                  setup["jax_out"][0][1],
                                  setup["jax_out"][1][1])
    assert ts_.step == int(js.step) == 2 and ts_.opt_count == 1
    _assert_step_close(ts_.model, js.params, mean, lr_fn(0), "params")
    _assert_step_close(ts_.ema_model, js.ema_params, mean, lr_fn(0), "ema")


def test_exp_training_factories_match_jax_exp():
    """The training fields, the learning-rate function and the optimizer's
    settings of the port's ExpTrack against the JAX package's."""
    je, te = JExp(), TExp()
    for field in ("warmup_epochs", "max_epoch", "warmup_lr", "basic_lr_per_img",
                  "scheduler", "no_aug_epochs", "min_lr_ratio", "ema", "mhs",
                  "weight_decay", "always_l1", "use_grad_acc", "grad_acc_step",
                  "bidirect", "train_mode", "alter_step", "mot_weight",
                  "scale_all_mot", "input_size", "remat"):
        assert getattr(te, field) == getattr(je, field), field
    j_lr, t_lr = je.get_lr_fn(16, 100), te.get_lr_fn(16, 100)
    for it in (0, 1, 50, 100, 101, 700, 1199, 1200, 1400):
        np.testing.assert_allclose(t_lr(it), float(j_lr(it)), rtol=1e-5,
                                   atol=1e-12)
    tx = te.get_optimizer(16, 100)
    assert (tx.kind, tx.weight_decay, tx.grad_accum) == ("adamw", 5e-4, 2)
    assert tx.no_decay_mask_fn is tts.default_wd_mask
    assert tx.lr_fn(50) == t_lr(50)


def test_step_needs_a_card_unless_asked_for_the_cpu(setup):
    tx = tts.make_optimizer(lr_fn)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tts.TrainState.create(_torch_model(setup["state"]), tx)
    # backbone_map and remat are ported: the loss is the one without them
    model = _torch_model(setup["state"])
    batch = _torch_batch(setup["batches"][0])
    with torch.no_grad():
        want = uni_loss_fn(model, *batch, (H, W), **LOSS_KW)[0]
        got = uni_loss_fn(model, *batch, (H, W), backbone_map=True,
                          **LOSS_KW)[0]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    assert TUnicorn(**CFG, remat=True).backbone.backbone.remat is True


def test_det_train_step_runs_and_lowers_its_loss(setup):
    """make_det_train_step on a YOLOXDet, the det stage's model, with the
    module's Unicorn weights (every YOLOXDet tensor is one of the
    Unicorn's; its loss, det_loss_fn, is held against JAX's in
    test_torch_port_det_train.py): finite losses that fall over four SGD
    steps on one batch."""
    tx = tts.make_optimizer(lambda c: 1e-3, kind="sgd", weight_decay=WD,
                            no_decay_mask_fn=tts.default_wd_mask)
    model = TDet(**CFG, use_attention=True)
    model.load_state_dict({k: setup["state"][k]
                           for k in model.state_dict()})
    model.train()
    state = tts.TrainState.create(model, tx, device="cpu")
    images, targets, _ = _torch_batch(setup["batches"][0])
    step = make_det_train_step((H, W), use_l1=True)
    losses = [step(state, images[:, 1], targets[:, 1, :, :5])[1]["total_loss"]
              .item() for _ in range(4)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
