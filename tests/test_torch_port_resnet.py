"""The port's ResNet-50 (unicorn_torch/models/resnet.py) against the JAX
package's, on the CPU: BottleneckRes at stride 1 and 2 with and without the
projection, ResNet50(layers=(1, 1, 1, 1)) at an odd size (72x104: the stem
pool and the stride-2 convs meet ragged borders), its gradients, and one
full-depth r50 Unicorn (depth 0.33, width 0.5, one attention block a
level, 64x64) through forward_whole, with the weight bridge.

Parameters come from the port's seeded init and go to JAX through
unicorn_torch.convert (map_resnet, to_flax); the Unicorn's tree is held
against the JAX model's own init tree (jax.eval_shape), and flax -> torch
-> flax is the identity.

Tolerances. fp32: atol 1e-4 on activations (as the port's other model
tests; the two sum in other orders, and flax's GroupNorm takes E[x^2] -
E[x]^2). bf16: the bound of the bf16 deformable interaction, 2.5% of the
output's |max| for the largest difference and 0.5% for the mean (the
frameworks round the convs' sums at other points; measured 1.4% / 0.13%
on the small ResNet). The
whole bf16 Unicorn carries that through the PAFPN and head: it is held to
the bound tests/test_torch_port_model.py holds the ConvNeXt Unicorn to, 5%
and 1.5% (measured 2.8% / 0.67%). Gradients: every entry within 1e-3 of its
leaf's largest magnitude.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unicorn_torch import convert
from unicorn_torch.models.blocks import init_weights
from unicorn_torch.models.pafpn import build_backbone
from unicorn_torch.models.resnet import BottleneckRes, ResNet50
from unicorn_torch.models.unicorn import Unicorn as TUnicorn
from unicorn_tpu.models.resnet import BottleneckRes as JBottleneckRes
from unicorn_tpu.models.resnet import ResNet50 as JResNet50
from unicorn_tpu.models.unicorn import Unicorn as JUnicorn

SMALL = (1, 1, 1, 1)
CFG = dict(num_classes=8, backbone_name="resnet50", depth=0.33, width=0.5,
           in_channels=(512, 1024, 2048), n_layer_att=1)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(
        0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _nhwc(t):
    return t.float().permute(0, 2, 3, 1).detach().numpy()


def _image(shape, seed):
    return (np.random.RandomState(seed).rand(*shape) * 255).astype(
        np.float32)


def _seeded(module, seed=0):
    init_weights(module, torch.Generator().manual_seed(seed))
    return module


def _flax(named, layers):
    """torch names of a ResNet50(layers) -> its flax tree (numpy)."""
    rules = convert.map_resnet("r", layers)
    tree = {}
    for name, t in named.items():
        path, tf = rules[name]
        w = t.detach().float().numpy()
        node = tree
        *parents, leaf = path.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = tf(w) if tf is not None else w
    return tree["r"]


def _leaves(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path): v
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_bf16(got, want, largest=0.025, mean=0.005):
    want = np.asarray(want).astype(np.float32)
    d = np.abs(got - want)
    scale = np.abs(want).max()
    assert d.max() <= largest * scale and d.mean() <= mean * scale, (
        d.max() / scale, d.mean() / scale)


@pytest.mark.parametrize("stride,downsample,inplanes", [
    (1, True, 24), (2, True, 24), (1, False, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bottleneck_matches_jax(stride, downsample, inplanes, dtype):
    planes = 16
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    block = _seeded(BottleneckRes(inplanes, planes, stride, downsample,
                                  dtype=tdt))
    tree = _flax({f"layer1.0.{k}": v for k, v in block.state_dict().items()},
                 (1,))["BottleneckRes_0"]
    x = np.random.RandomState(1).randn(2, 13, 17, inplanes).astype(
        np.float32)
    want = JBottleneckRes(planes, stride, downsample, dtype=jdt).apply(
        {"params": tree}, jnp.asarray(x, jdt))
    with torch.no_grad():
        got = block(_nchw(x).to(tdt))
    assert got.dtype == tdt
    assert got.shape[1:] == (4 * planes,) + want.shape[1:3]
    if dtype == "float32":
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-4)
    else:
        _assert_bf16(_nhwc(got), want)


@pytest.fixture(scope="module")
def small():
    """The seeded ResNet50(layers=(1, 1, 1, 1)), its flax tree and an
    odd-sized image."""
    torch.set_num_threads(1)
    model = _seeded(ResNet50(SMALL))
    return model, _flax(model.state_dict(), SMALL), _image((1, 72, 104, 3), 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resnet50_matches_jax(small, dtype):
    model, tree, img = small
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    want = jax.jit(JResNet50(SMALL, dtype=jdt).apply)(
        {"params": tree}, jnp.asarray(img))
    m = ResNet50(SMALL, dtype=tdt)
    m.load_state_dict(model.state_dict())
    with torch.no_grad():
        got = m(_nchw(img))
    assert len(got) == len(want) == 3
    for g, w, c, s in zip(got, want, (512, 1024, 2048), (8, 16, 32)):
        assert g.shape == (1, c, -(-72 // s), -(-104 // s)), g.shape
        assert g.dtype == tdt
        if dtype == "float32":
            np.testing.assert_allclose(_nhwc(g), np.asarray(w), atol=1e-4)
        else:
            _assert_bf16(_nhwc(g), w)


OFFSETS = [np.random.RandomState(5).randn(c).astype(np.float32)
           for c in (512, 1024, 2048)]


def test_resnet50_gradients_match_jax(small):
    """sum over the three outputs of mean((o + offset)^2): every gradient
    leaf through the bridge against JAX's."""
    model, tree, img = small
    model.zero_grad(set_to_none=True)
    outs = model(_nchw(img))
    loss = sum(((o + torch.from_numpy(w)[:, None, None]) ** 2).mean()
               for o, w in zip(outs, OFFSETS))
    loss.backward()
    jm = JResNet50(SMALL)

    def j_loss(params):
        outs = jm.apply({"params": params}, jnp.asarray(img))
        return sum(jnp.mean((o + w) ** 2) for o, w in zip(outs, OFFSETS))

    j_total, j_grads = jax.jit(jax.value_and_grad(j_loss))(tree)
    assert abs(loss.item() - float(j_total)) <= 1e-5 * abs(float(j_total))
    mine = _leaves(_flax({n: p.grad for n, p in model.named_parameters()},
                         SMALL))
    want = _leaves(j_grads)
    assert mine.keys() == want.keys() and len(want) == len(
        list(model.parameters()))
    for path, g in want.items():
        g = np.asarray(g)
        assert np.abs(mine[path] - g).max() <= 1e-3 * np.abs(g).max(), path


def test_build_backbone_resnet50():
    """resnet50 -> (ResNet50, (512, 1024, 2048)); at width 0.5 the PAFPN
    builds adjust0/1/2 (raw != (256, 512, 1024)), the interaction's
    bottleneck takes the raw stride-16 width, and remat is ignored, as in
    the JAX package."""
    m, ch = build_backbone("resnet50", remat=True)
    assert isinstance(m, ResNet50) and ch == (512, 1024, 2048)
    assert [len(getattr(m, f"layer{s}")) for s in range(1, 5)] == [3, 4, 6, 3]
    assert all(getattr(m, f"layer{s}")[0].downsample is not None
               for s in range(1, 5))
    tm = TUnicorn(**CFG)
    assert tm.backbone.adjust and tm.backbone.raw_channels == (512, 1024,
                                                               2048)
    assert tm.backbone.adjust1.conv.in_channels == 1024
    assert tm.backbone.adjust1.conv.out_channels == 512
    assert tm.bottleneck[0].in_channels == 1024


@pytest.fixture(scope="module")
def unicorn():
    """The seeded r50 Unicorn, its flax tree, and the JAX model's own init
    tree's shapes."""
    torch.set_num_threads(1)
    tm = TUnicorn(**CFG).eval()
    shapes = jax.eval_shape(
        functools.partial(JUnicorn(**CFG).init, method=JUnicorn.init_all),
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32))
    return tm, convert.to_flax(tm.state_dict()), shapes["params"]


def test_unicorn_bridge_round_trip(unicorn):
    """Every leaf of the JAX r50 Unicorn's tree is mapped exactly once:
    random leaves of the JAX tree's shapes go to a state_dict with exactly
    the port's names and back unchanged; the port's init tree has the JAX
    tree's paths and shapes."""
    tm, tree, shapes = unicorn
    want = {k: tuple(v.shape) for k, v in _leaves(shapes).items()}
    assert {k: v.shape for k, v in _leaves(tree).items()} == want
    rng = np.random.RandomState(3)
    params = jax.tree_util.tree_map(
        lambda s: rng.randn(*s.shape).astype(np.float32), shapes)
    state = convert.from_flax(params)
    assert len(state) == len(want)
    assert set(state) == set(tm.state_dict())
    back = _leaves(convert.to_flax(state))
    for k, v in _leaves(params).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    assert sum(k.startswith("backbone/ResNet50_0/") for k in want) == 159


def test_unicorn_forward_whole_matches_jax(unicorn):
    tm, tree, _ = unicorn
    img = _image((1, 64, 64, 3), 4)
    raw_j, f16_j = jax.jit(functools.partial(
        JUnicorn(**CFG).apply, method=JUnicorn.forward_whole))(
        {"params": tree}, jnp.asarray(img))
    with torch.no_grad():
        raw_t, f16_t = tm.forward_whole(_nchw(img))
    assert f16_t.shape == (1, 1024, 4, 4)
    np.testing.assert_allclose(_nhwc(f16_t), np.asarray(f16_j), atol=1e-4)
    for lj, lt in zip(raw_j, raw_t):
        assert set(lj) == set(lt)
        for key in lj:
            np.testing.assert_allclose(_nhwc(lt[key]), np.asarray(lj[key]),
                                       atol=1e-4, err_msg=key)


def test_unicorn_forward_whole_matches_jax_bf16(unicorn):
    tm, tree, _ = unicorn
    img = _image((1, 64, 64, 3), 4)
    raw_j, _ = jax.jit(functools.partial(
        JUnicorn(**CFG, dtype=jnp.bfloat16).apply,
        method=JUnicorn.forward_whole))({"params": tree}, jnp.asarray(img))
    t = TUnicorn(**CFG, dtype=torch.bfloat16)
    t.load_state_dict(tm.state_dict())
    with torch.no_grad():
        raw_t, _ = t.eval().forward_whole(_nchw(img))
    for lj, lt in zip(raw_j, raw_t):
        for key in ("_cls_packed", "_reg_packed"):
            assert lt[key].dtype == torch.bfloat16
            _assert_bf16(_nhwc(lt[key]), lj[key], 0.05, 0.015)
