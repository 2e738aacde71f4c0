"""The port's inst-stage training step (unicorn_torch/core/train_step.py
`det_mask_loss_fn`, `make_det_mask_train_step`; exp/det_mask.py
`get_optimizer`, `get_train_step`, `mask_only_trainable`) against the JAX
package's, on the CPU.

The JAX mask-stage tests' YOLOXDet (tests/test_mask_stage.py:70: CSPDarknet
depth 0.33 width 0.25, no head attention, 5 classes) with the semantic head
(sem_loss_on), fp32, on 64x64 images with masks at d_rate 4. Parameters
come from the port's seeded init and reach JAX through convert.to_flax. The
JAX loss-and-gradient functions (CondInst with the semantic term weighted 0
or 1, and BoxInst with its warm-up factor as an argument) are compiled once
for the module.

Tolerances, set before the first run at the uni step's
(tests/test_torch_port_train_step.py): the loss dict rtol 1e-4, atol 1e-6;
gradients leaf by leaf within 1e-3 of the leaf's largest magnitude; SGD
from the same gradients rtol 1e-5, atol 1e-7 (parameters and EMA); the
whole step (the port's own gradients): each leaf's update within 2e-3 of
its largest entry of JAX's update (SGD is linear in the gradient), plus two
fp32 ulps of the leaf's largest parameter. Frozen tensors are compared bit
for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unicorn_torch.convert import from_flax, to_flax
from unicorn_torch.core.train_state import TrainState
from unicorn_torch.core.train_step import (det_mask_loss_fn,
                                           make_det_mask_train_step)
from unicorn_torch.exp.det_mask import mask_only_trainable
from unicorn_torch.exp.unicorn_inst_convnext_tiny_800x1280 import Exp as TExp
from unicorn_torch.models.unicorn import YOLOXDet as TDet
from unicorn_tpu.core import train_state as jts
from unicorn_tpu.core.train_step import det_mask_loss_fn as j_loss_fn
from unicorn_tpu.exp import det_mask as jdm
from unicorn_tpu.models.unicorn import YOLOXDet as JDet

H = W = 64
D_RATE = 4
CFG = dict(num_classes=5, backbone_name="csp_darknet", depth=0.33,
           width=0.25, in_channels=(256, 512, 1024), use_attention=False,
           n_layer_att=0, use_mask=True, sem_loss_on=True)
# the exp's schedule, with a learning rate that moves the parameters well
# beyond the tolerances and a first step that is not 0
EXP_FIELDS = dict(basic_lr_per_img=0.05, warmup_lr=0.02, input_size=(H, W))
ITERS_PER_EPOCH = 4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _batch(seed):
    """Two images with 3 and 4 boxes of classes 0-4 (one class-4 box has
    its mask empty), masks as rectangles with even edges: shrunk 2x for
    the semantic head they land on no value at 0.5 (the threshold)."""
    rng = np.random.RandomState(seed)
    images = (rng.rand(2, H, W, 3) * 255).astype(np.float32)
    labels = np.zeros((2, 6, 5), np.float32)
    Hm, Wm = H // D_RATE, W // D_RATE
    masks = np.zeros((2, 6, Hm, Wm), np.float32)
    for b, n in enumerate((3, 4)):
        for i in range(n):
            y0, x0 = 2 * rng.randint(0, 5), 2 * rng.randint(0, 5)
            h, w = 2 * rng.randint(2, 4), 2 * rng.randint(2, 4)
            masks[b, i, y0:y0 + h, x0:x0 + w] = 1.0 if i < 3 else 0.0
            labels[b, i] = [i + b, D_RATE * (x0 + w / 2),
                            D_RATE * (y0 + h / 2), D_RATE * w, D_RATE * h]
    return images, labels, masks


def _torch_batch(batch):
    images, labels, masks = batch
    return (torch.from_numpy(images).permute(0, 3, 1, 2).contiguous(),
            torch.from_numpy(labels), torch.from_numpy(masks))


def _leaves(tree):
    return {"/".join(str(p.key) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(1)
    tm = TDet(**CFG, generator=torch.Generator().manual_seed(0))
    state = {k: v.clone() for k, v in tm.state_dict().items()}
    params = {"params": to_flax(state)}
    jm = JDet(**CFG)

    @jax.jit
    def cond_fn(p, images, labels, masks, sem_w):
        def loss(p_):
            total, d = j_loss_fn(jm, p_, images, labels, masks, (H, W),
                                 sem_loss_on=True, d_rate=D_RATE)
            return total - (1.0 - sem_w) * d["sem_loss"], d
        (total, d), g = jax.value_and_grad(loss, has_aux=True)(p)
        return total, d, g

    @jax.jit
    def box_fn(p, images, labels, masks, warm):
        def loss(p_):
            return j_loss_fn(jm, p_, images, labels, masks, (H, W),
                             boxinst=True, warmup_factor=warm, d_rate=D_RATE)
        (total, d), g = jax.value_and_grad(loss, has_aux=True)(p)
        return total, d, g

    batches = [_batch(0), _batch(1)]
    # the semantic targets of both batches clear the 0.5 threshold
    for _, _, masks in batches:
        small = np.asarray(jax.image.resize(
            jnp.asarray(masks), masks.shape[:2] + (H // 8, W // 8),
            "bilinear"))
        assert (np.abs(small - 0.5) > 1e-6).all()
    jb = [tuple(map(jnp.asarray, b)) for b in batches]
    jax_out = {
        "condinst": cond_fn(params, *jb[0], 0.0),
        "sem": cond_fn(params, *jb[0], 1.0),
        "boxinst": box_fn(params, *jb[0], 0.5),
    }
    return dict(state=state, params=params, batches=batches, jb=jb,
                cond_fn=cond_fn, box_fn=box_fn, jax_out=jax_out)


def _torch_model(setup, mask_only=False):
    m = TDet(**CFG)
    m.load_state_dict(setup["state"])
    if mask_only:
        for n, p in m.named_parameters():
            p.requires_grad_(mask_only_trainable([(n, p)])[n])
    return m.train()


VARIANTS = {"condinst": {}, "sem": dict(sem_loss_on=True),
            "boxinst": dict(boxinst=True, warmup_factor=0.5)}


def _jax_dict(setup, variant):
    total, d, _ = setup["jax_out"][variant]
    d = {k: float(v) for k, v in d.items()}
    if variant == "condinst":
        d.pop("sem_loss")
    d["total_loss"] = float(total)
    return d


def _torch_loss_and_grads(setup, variant, mask_only):
    model = _torch_model(setup, mask_only)
    total, loss_dict = det_mask_loss_fn(
        model, *_torch_batch(setup["batches"][0]), (H, W), d_rate=D_RATE,
        **VARIANTS[variant])
    total.backward()
    return model, {k: v.item() for k, v in loss_dict.items()}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_inst_loss_dict_matches_jax(setup, variant):
    _, got = _torch_loss_and_grads(setup, variant, False)
    ref = _jax_dict(setup, variant)
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-6, err_msg=k)
    assert got["condinst_loss"] > 0
    if variant == "boxinst":
        assert got["boxinst_prj_loss"] > 0 and got["boxinst_pairwise_loss"] > 0
    if variant == "sem":
        assert got["sem_loss"] > 0


@pytest.mark.parametrize("mask_only", [True, False])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_inst_gradients_match_jax_leaf_by_leaf(setup, variant, mask_only):
    """mask_only: only the trainable tensors get a gradient (the frozen
    ones do not require one); else every tensor, against JAX's."""
    model, _ = _torch_loss_and_grads(setup, variant, mask_only)
    trains = mask_only_trainable(model.named_parameters())
    grads = {}
    for n, p in model.named_parameters():
        if mask_only and not trains[n]:
            assert p.grad is None and not p.requires_grad, n
            continue
        # the semantic head of a loss without the semantic term: no gradient
        grads[n] = p.grad if p.grad is not None else torch.zeros_like(p)
    got = _leaves(to_flax(grads))
    ref = _leaves(setup["jax_out"][variant][2]["params"])
    assert set(got) <= set(ref) and (mask_only or set(got) == set(ref))
    bad = {}
    for path, g in got.items():
        scale = max(np.abs(ref[path]).max(), 1e-12)
        worst = np.abs(g - ref[path]).max() / scale
        if worst > 1e-3:
            bad[path] = worst
    assert not bad, bad
    assert sum(np.abs(g).max() > 0 for g in got.values()) > 0.5 * len(got)


def test_trainable_set_is_jax_mask_rule(setup):
    """mask_only_trainable on torch names against JAX's path rule on flax
    paths, through the bridge: the controllers and the whole mask branch
    (the semantic head too), nothing else."""
    model = _torch_model(setup)
    trains = mask_only_trainable(model.named_parameters())
    got = _leaves(to_flax({n: torch.full_like(p, float(trains[n]))
                           for n, p in model.named_parameters()}))
    ref = _leaves(jdm.mask_only_trainable(setup["params"]))
    ref = {k.removeprefix("params/"): v for k, v in ref.items()}
    assert set(got) == set(ref)
    for path, t in ref.items():
        assert got[path].min() == got[path].max() == float(bool(t)), path
    assert any(trains.values()) and not all(trains.values())
    assert trains["head.controllers.2.bias"]
    assert trains["head.mask_branch.logits.weight"]
    assert not trains["head.reg_preds.0.weight"]


def _exps():
    te, je = TExp(), jdm.ExpDetMask()
    for e in (te, je):
        for k, v in EXP_FIELDS.items():
            setattr(e, k, v)
    return te, je


def test_exp_fields_and_factories_match_jax():
    te, je = TExp(), jdm.ExpDetMask()
    for field in ("warmup_epochs", "max_epoch", "warmup_lr",
                  "basic_lr_per_img", "scheduler", "no_aug_epochs",
                  "min_lr_ratio", "ema", "always_l1", "weight_decay",
                  "momentum", "use_grad_acc", "grad_acc_step", "max_labels",
                  "train_mask_only", "d_rate", "boxinst",
                  "boxinst_warmup_iters", "num_classes"):
        assert getattr(te, field) == getattr(je, field), field
    j_lr, t_lr = je.get_lr_fn(16, 100), te.get_lr_fn(16, 100)
    for it in (0, 1, 50, 100, 101, 700, 1199):
        np.testing.assert_allclose(t_lr(it), float(j_lr(it)), rtol=1e-5,
                                   atol=1e-12)
    tx = te.get_optimizer(16, 100)
    assert (tx.kind, tx.weight_decay, tx.momentum, tx.grad_accum) == (
        "sgd", 5e-2, 0.9, 1)
    assert tx.trainable_mask_fn is mask_only_trainable
    te.train_mask_only = False
    assert te.get_optimizer(16, 100).trainable_mask_fn is None


def _states(setup, boxinst=False, mask_only=True):
    te, je = _exps()
    te.boxinst = je.boxinst = boxinst
    te.train_mask_only = je.train_mask_only = mask_only
    te.boxinst_warmup_iters = 2
    js = jts.TrainState.create(setup["params"],
                               je.get_optimizer(2, ITERS_PER_EPOCH))
    ts_ = TrainState.create(_torch_model(setup),
                            te.get_optimizer(2, ITERS_PER_EPOCH),
                            use_ema=te.ema, device="cpu")
    return te, js, ts_


def _frozen_and_trainable(model):
    trains = mask_only_trainable(model.named_parameters())
    return ({n: p.detach().clone() for n, p in model.named_parameters()
             if not trains[n]}, trains)


def _assert_frozen(model, frozen, trains):
    for n, p in model.named_parameters():
        if n in frozen:
            assert torch.equal(p, frozen[n]) and not p.requires_grad, n
    assert all(trains[n] == p.requires_grad
               for n, p in model.named_parameters())


def _assert_close(model, jax_params, what, rtol=1e-5, atol=1e-7):
    got = _leaves(to_flax(dict(model.named_parameters())))
    for path, v in _leaves(jax_params["params"]).items():
        np.testing.assert_allclose(got[path], v, rtol=rtol, atol=atol,
                                   err_msg=f"{what} {path}")


def test_sgd_mask_only_from_same_gradients_matches_optax(setup):
    """Two SGD updates of the exps' mask-only rules from JAX's gradients
    (both batches', with the semantic term, so that every trainable tensor
    has a gradient): parameters and EMA match optax's, the frozen tensors
    (whose gradients JAX computes and masks) do not move, the trainable
    ones do."""
    _, js, ts_ = _states(setup)
    frozen, trains = _frozen_and_trainable(ts_.model)
    start = {n: p.detach().clone() for n, p in ts_.model.named_parameters()}
    for i in range(2):
        grads = setup["cond_fn"](setup["params"], *setup["jb"][i], 1.0)[2]
        js = js.apply_gradients(grads)
        state = from_flax(grads["params"])
        for n, p in ts_.model.named_parameters():
            if p.requires_grad:
                p.grad = state[n].clone()
        ts_.apply_gradients()
        _assert_close(ts_.model, js.params, f"update {i + 1}")
        _assert_close(ts_.ema_model, js.ema_params, f"ema {i + 1}")
    _assert_frozen(ts_.model, frozen, trains)
    moved = [n for n, p in ts_.model.named_parameters()
             if trains[n] and not torch.equal(p, start[n])]
    assert len(moved) == sum(trains.values())


def _assert_update_close(model, start, jax_params, what):
    got = _leaves(to_flax(dict(model.named_parameters())))
    p0 = _leaves(to_flax(start))
    for path, v in _leaves(jax_params["params"]).items():
        dj, dt = v - p0[path], got[path] - p0[path]
        # plus two fp32 ulps of the parameter, in which p + update rounds
        bound = 2e-3 * np.abs(dj).max() + 2.4e-7 * np.abs(v).max()
        assert np.abs(dt - dj).max() <= bound, (what, path)


@pytest.mark.parametrize("boxinst, mask_only", [(False, True), (True, True),
                                                (False, False)])
def test_whole_steps_match_jax(setup, boxinst, mask_only):
    """Two steps of the exp's train step (the port's own gradients) against
    optax with JAX's gradients at the same parameters. With BoxInst and
    boxinst_warmup_iters 2 the pairwise term is weighted 0, then 0.5: the
    warm-up reads the step count before the update. Without
    train_mask_only every tensor trains."""
    te, js, ts_ = _states(setup, boxinst, mask_only)
    step = te.get_train_step(2)
    frozen, trains = _frozen_and_trainable(ts_.model)
    fn = setup["box_fn"] if boxinst else setup["cond_fn"]
    for i in range(2):
        start = {n: p.detach().clone()
                 for n, p in ts_.model.named_parameters()}
        _, loss_dict = step(ts_, *_torch_batch(setup["batches"][i]))
        arg = 0.5 * i if boxinst else 0.0
        total, d, grads = fn(js.params, *setup["jb"][i], arg)
        js = js.apply_gradients(grads)
        np.testing.assert_allclose(loss_dict["total_loss"].item(),
                                   float(total), rtol=1e-4, atol=1e-6)
        if boxinst:
            pw = loss_dict["boxinst_pairwise_loss"].item()
            np.testing.assert_allclose(pw, float(d["boxinst_pairwise_loss"]),
                                       rtol=1e-4, atol=1e-6)
            assert (pw == 0.0) if i == 0 else (pw > 0.0)
        _assert_update_close(ts_.model, start, js.params, f"step {i + 1}")
    if mask_only:
        _assert_frozen(ts_.model, frozen, trains)
    else:
        assert all(p.requires_grad for p in ts_.model.parameters())
        assert not any(torch.equal(p, frozen[n])
                       for n, p in ts_.model.named_parameters() if n in frozen
                       and p.dim() > 1)
    assert ts_.step == int(js.step) == 2


def test_semantic_step_runs_through_the_factory(setup):
    """make_det_mask_train_step(sem_loss_on=True): the loss dict carries the
    semantic term of JAX's loss at the same parameters."""
    state = TrainState.create(_torch_model(setup),
                              _exps()[0].get_optimizer(2, ITERS_PER_EPOCH),
                              use_ema=False, device="cpu")
    step = make_det_mask_train_step((H, W), sem_loss_on=True, d_rate=D_RATE)
    _, loss_dict = step(state, *_torch_batch(setup["batches"][0]))
    ref = _jax_dict(setup, "sem")
    for k in ("sem_loss", "condinst_loss", "total_loss"):
        np.testing.assert_allclose(loss_dict[k].item(), ref[k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)
