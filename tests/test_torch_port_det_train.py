"""The port's det-stage loss (unicorn_torch/core/train_step.py
`det_loss_fn`, the loss that `make_det_train_step` and the Trainer's det
stage step) against the JAX package's `det_loss_fn`, on the CPU.

The det exps' YOLOXDet cut to CPU size: the ConvNeXt-Tiny trunk at its
published widths, the PAFPN and head at width 0.5, one attention block per
level, 80 classes, fp32, on two 64x96 images with 5 and 3 boxes. Parameters
come from the port's seeded init and reach JAX through convert.to_flax. The
JAX loss-and-gradient function is compiled once for the module, with L1 off
and on.

Tolerances, those of the uni step (tests/test_torch_port_train_step.py):
  * the loss dict: rtol 1e-4, atol 1e-6 (the model's activations agree to
    1e-4, see test_torch_port_model.py);
  * gradients, leaf by leaf through convert.to_flax: every entry within 1e-3
    of the leaf's largest magnitude.
"""
import jax
import numpy as np
import pytest
import torch

from unicorn_torch.convert import to_flax
from unicorn_torch.core.train_step import det_loss_fn
from unicorn_torch.models.unicorn import YOLOXDet as TDet
from unicorn_tpu.core.train_step import det_loss_fn as j_det_loss_fn
from unicorn_tpu.models.unicorn import YOLOXDet as JDet

H, W = 64, 96
CFG = dict(num_classes=80, backbone_name="convnext_tiny", width=0.5,
           use_attention=True, n_layer_att=1)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _batch():
    """images (2, H, W, 3) in [0, 255]; labels (2, 8, 5) rows (class, cx,
    cy, w, h) with 5 and 3 boxes, the rest zero."""
    rng = np.random.RandomState(7)
    images = (rng.rand(2, H, W, 3) * 255).astype(np.float32)
    labels = np.zeros((2, 8, 5), np.float32)
    for b, n in enumerate((5, 3)):
        labels[b, :n, 0] = rng.randint(0, 80, n)
        labels[b, :n, 1:3] = rng.uniform(0.2, 0.8, (n, 2)) * (W, H)
        labels[b, :n, 3:5] = rng.uniform(8, 30, (n, 2))
    return images, labels


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
    def j_fn(p, images, labels):
        out = {}
        for use_l1 in (False, True):
            (total, d), g = jax.value_and_grad(
                lambda p_: j_det_loss_fn(jm, p_, images, labels, (H, W),
                                         use_l1=use_l1),
                has_aux=True)(p)
            out[use_l1] = (total, d, g)
        return out

    images, labels = _batch()
    return dict(state=state, batch=(images, labels),
                jax_out=j_fn(params, images, labels))


def _torch_loss_and_grads(setup, use_l1):
    model = TDet(**CFG)
    model.load_state_dict(setup["state"])
    model.train()
    images, labels = setup["batch"]
    total, loss_dict = det_loss_fn(
        model, torch.from_numpy(images).permute(0, 3, 1, 2).contiguous(),
        torch.from_numpy(labels), (H, W), use_l1=use_l1)
    total.backward()
    return model, {k: v.item() for k, v in loss_dict.items()}


@pytest.mark.parametrize("use_l1", [False, True])
def test_det_loss_dict_matches_jax(setup, use_l1):
    _, got = _torch_loss_and_grads(setup, use_l1)
    total, d, _ = setup["jax_out"][use_l1]
    ref = {k: float(v) for k, v in d.items()}
    ref["total_loss"] = float(total)
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-6, err_msg=k)
    assert got["num_fg"] > 0 and got["iou_loss"] > 0 and got["cls_loss"] > 0
    assert (got["l1_loss"] > 0) == use_l1


@pytest.mark.parametrize("use_l1", [False, True])
def test_det_gradients_match_jax_leaf_by_leaf(setup, use_l1):
    model, _ = _torch_loss_and_grads(setup, use_l1)
    got = _leaves(to_flax({n: p.grad for n, p in model.named_parameters()}))
    ref = _leaves(setup["jax_out"][use_l1][2]["params"])
    assert set(got) == set(ref)
    bad = {}
    for path, g in got.items():
        scale = max(np.abs(ref[path]).max(), 1e-12)
        worst = np.abs(g - ref[path]).max() / scale
        if worst > 1e-3:
            bad[path] = worst
    assert not bad, bad
    assert sum(np.abs(g).max() > 0 for g in got.values()) > 0.5 * len(got)
