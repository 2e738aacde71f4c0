"""Backbone remat and backbone_map in the port (unicorn_torch/models
convnext.py / blocks.py, core/train_step.py) against the port without them
and against the JAX package's remat model, on the CPU; and the port's
copies of the det and large exps against exps/default/.

Tolerances.
  * remat True / "dw" against False, the same weights and inputs: the loss
    within 1e-6 of its value and every gradient entry within 1e-6 of its
    leaf's largest magnitude (the recomputation repeats the same ops: 0
    differ here).
  * backbone_map against one 2B batch: the loss within 1e-6 of its value
    (measured 1.8e-7), every gradient entry within 1e-4 of its leaf's
    largest magnitude (measured 2.8e-5 at worst, 1.1e-5 the median leaf:
    a weight's gradient sums the frames' terms in other orders when each
    frame runs at batch 1).
  * the port's remat trunk against JAX's (fp32, the same weights through
    unicorn_torch.convert.to_flax): the loss within 1e-6 of its value
    (measured 1.9e-7), every gradient entry within 1e-5 of its leaf's
    largest magnitude (measured 8.5e-7; flax's LayerNorm takes the
    variance as E[x^2] - E[x]^2).
"""
import importlib
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unicorn_torch.convert import to_flax
from unicorn_torch.core.train_step import det_loss_fn, uni_loss_fn
from unicorn_torch.models.blocks import init_weights
from unicorn_torch.models.convnext import ConvNeXt
from unicorn_torch.models.unicorn import Unicorn, YOLOXDet
from unicorn_tpu.models.convnext import ConvNeXt as JConvNeXt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPTHS, DIMS = (1, 1, 2, 1), (16, 32, 48, 64)
H, W = 64, 96


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _trunk(remat):
    """The small trunk, seeded weights with layer scales near 0.5 so that
    every block counts."""
    m = ConvNeXt(DEPTHS, DIMS, remat=remat)
    init_weights(m, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name.endswith("gamma"):
                p.copy_(0.3 + 0.4 * torch.rand(p.shape, generator=g))
    return m.train()


def _image(seed=0, b=2):
    return np.random.RandomState(seed).rand(b, H, W, 3).astype(
        np.float32) * 255


# per-channel offsets of the trunk's loss: without them the loss of the
# LayerNorm'd outputs is nearly constant and its gradients are noise
OFFSETS = [np.random.RandomState(5).randn(c).astype(np.float32)
           for c in DIMS[1:]]


def _trunk_loss(outs):
    """sum over the three outputs (NCHW) of mean((o + offset) ** 2)."""
    return sum(((o.float() + torch.from_numpy(w)[:, None, None]) ** 2).mean()
               for o, w in zip(outs, OFFSETS))


def _loss_and_grads(model, loss):
    model.zero_grad(set_to_none=True)
    total = loss()
    total.backward()
    return total.item(), {n: p.grad.clone() for n, p in
                          model.named_parameters() if p.grad is not None}


def _assert_grads(got, want, share):
    assert got.keys() == want.keys()
    for name, g in want.items():
        bound = share * float(g.abs().max()) + 1e-30
        assert float((got[name] - g).abs().max()) <= bound, name


@pytest.mark.parametrize("remat", [True, "dw"])
def test_trunk_remat_matches_no_remat(remat):
    x = torch.from_numpy(_image()).permute(0, 3, 1, 2)
    want = _loss_and_grads(m := _trunk(False), lambda: _trunk_loss(m(x)))
    model = _trunk(remat)
    got = _loss_and_grads(model, lambda: _trunk_loss(model(x)))
    assert abs(got[0] - want[0]) <= 1e-6 * abs(want[0])
    _assert_grads(got[1], want[1], 1e-6)
    assert len(got[1]) == len(list(model.parameters()))


@pytest.mark.parametrize("remat", [True, "dw"])
def test_trunk_remat_matches_jax(remat):
    """The port's remat trunk against JAX's ConvNeXt(remat=...) from the
    same weights: loss and every gradient leaf."""
    model = _trunk(remat)
    img = _image(1)
    x = torch.from_numpy(img).permute(0, 3, 1, 2)
    loss, grads = _loss_and_grads(model, lambda: _trunk_loss(model(x)))

    def flax_tree(named):
        tree = to_flax({f"backbone.backbone.{k}": v for k, v in
                        named.items()})
        return tree["backbone"]["ConvNeXt_0"]

    jm = JConvNeXt(depths=DEPTHS, dims=DIMS, remat=remat)

    @jax.jit
    def j_loss(params, imgs):
        outs = jm.apply({"params": params}, imgs)
        return sum(jnp.mean((o.astype(jnp.float32) + w) ** 2)
                   for o, w in zip(outs, OFFSETS))

    params = flax_tree(dict(model.named_parameters()))
    j_total, j_grads = jax.value_and_grad(j_loss)(params, jnp.asarray(img))
    assert abs(loss - float(j_total)) <= 1e-6 * abs(float(j_total))
    mine = flax_tree(grads)
    flat_j = jax.tree_util.tree_leaves_with_path(j_grads)
    assert len(flat_j) == len(grads)
    for path, g in flat_j:
        node = mine
        for p in path:
            node = node[p.key]
        g = np.asarray(g)
        assert np.abs(node - g).max() <= 1e-5 * np.abs(g).max() + 1e-30, \
            jax.tree_util.keystr(path)


def _det_batch():
    rng = np.random.RandomState(3)
    labels = np.zeros((2, 8, 5), np.float32)
    for b in range(2):
        labels[b, :5, 0] = rng.randint(0, 80, 5)
        labels[b, :5, 1:3] = rng.uniform(0.2, 0.8, (5, 2)) * (W, H)
        labels[b, :5, 3:5] = rng.uniform(8, 30, (5, 2))
    return (torch.from_numpy(_image(2)).permute(0, 3, 1, 2).contiguous(),
            torch.from_numpy(labels))


def _det(remat):
    return YOLOXDet(backbone_name="convnext_tiny", width=0.5,
                    use_attention=True, n_layer_att=1, remat=remat,
                    generator=torch.Generator().manual_seed(0)).train()


@pytest.fixture(scope="module")
def det_plain():
    torch.set_num_threads(1)
    images, labels = _det_batch()
    model = _det(False)
    return _loss_and_grads(model, lambda: det_loss_fn(
        model, images, labels, (H, W))[0])


@pytest.mark.parametrize("remat", [True, "dw"])
def test_yoloxdet_remat_matches_no_remat(remat, det_plain):
    """YOLOXDet with each remat: the trunk's blocks take it, the head's
    attention blocks do not; the det loss and its gradients as without."""
    model = _det(remat)
    trunk = [b for s in model.backbone.backbone.stages for b in s]
    assert {b.remat for b in trunk} == {remat}
    head_blocks = [m for m in model.head.modules()
                   if type(m).__name__ == "ConvNeXtBlock"]
    assert head_blocks and not any(b.remat for b in head_blocks)
    images, labels = _det_batch()
    got = _loss_and_grads(model, lambda: det_loss_fn(
        model, images, labels, (H, W))[0])
    assert abs(got[0] - det_plain[0]) <= 1e-6 * abs(det_plain[0])
    _assert_grads(got[1], det_plain[1], 1e-6)


UH, UW = 96, 160
UNI = dict(num_classes=8, backbone_name="convnext_tiny", width=0.5,
           n_layer_att=1)
UNI_LOSS = dict(mot_weight=3.0, bidirect=True, use_l1=True, num_classes=8,
                mhs=True)


def _uni_batch():
    rng = np.random.RandomState(4)
    images = rng.rand(2, 2, 3, UH, UW).astype(np.float32) * 255
    targets = np.zeros((2, 2, 6, 6), np.float32)
    for b, n in enumerate((1, 4)):
        cxy = rng.uniform(0.2, 0.8, (n, 2)) * (UW, UH)
        for f in range(2):
            targets[b, f, :n, 0] = rng.randint(0, 8, n) if n > 1 else 0
            targets[b, f, :n, 1:3] = cxy + f * rng.uniform(-3, 3, (n, 2))
            targets[b, f, :n, 3:5] = rng.uniform(16, 48, (n, 2))
            targets[b, f, :n, 5] = np.arange(1, n + 1)
    return (torch.from_numpy(images), torch.from_numpy(targets),
            torch.tensor([1, 2]))


def _uni_run(remat, backbone_map):
    model = Unicorn(**UNI, remat=remat,
                    generator=torch.Generator().manual_seed(0)).train()
    batch = _uni_batch()
    return _loss_and_grads(model, lambda: uni_loss_fn(
        model, *batch, (UH, UW), backbone_map=backbone_map, **UNI_LOSS)[0])


@pytest.fixture(scope="module")
def uni_plain():
    torch.set_num_threads(1)
    return _uni_run(False, False)


@pytest.mark.parametrize("remat,backbone_map",
                         [(True, False), ("dw", False), (False, True),
                          ("dw", True)])
def test_unicorn_remat_and_backbone_map(remat, backbone_map, uni_plain):
    """uni_loss_fn on Unicorn with remat and / or backbone_map against
    neither: the loss within 1e-6, the gradients within 1e-6 (remat
    alone) or 1e-4 (with backbone_map) of each leaf's largest."""
    got = _uni_run(remat, backbone_map)
    assert abs(got[0] - uni_plain[0]) <= 1e-6 * abs(uni_plain[0])
    _assert_grads(got[1], uni_plain[1], 1e-4 if backbone_map else 1e-6)


@pytest.mark.parametrize("name", ["unicorn_det_convnext_tiny_800x1280",
                                  "unicorn_det_convnext_large_800x1280",
                                  "unicorn_track_large"])
def test_exp_copies_match_default_exps(name):
    """The port's exp copy has the fields of exps/default/<name>.py, but
    the port's own (seed, output_dir) and the JAX evaluators' (not
    ported)."""
    spec = importlib.util.spec_from_file_location(
        f"default_{name}", os.path.join(ROOT, "exps", "default",
                                        f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    port = importlib.import_module(f"unicorn_torch.exp.{name}")
    jv, tv = vars(mod.Exp()), vars(port.Exp())
    unported = {"grid_sample", "test_ann", "test_name", "test_data_dir"}
    assert set(tv) - set(jv) == {"seed", "output_dir"}
    assert set(jv) - set(tv) <= unported
    assert {k: tv[k] for k in jv if k not in unported} == \
        {k: v for k, v in jv.items() if k not in unported}
