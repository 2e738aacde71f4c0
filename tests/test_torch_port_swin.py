"""The port's Swin Transformer (unicorn_torch/models/swin.py) against the
JAX package's, on the CPU: window_partition / window_reverse, the
relative-position index of a clamped window, WindowAttention with and
without the shift mask, SwinBlock at sizes that pad with a shift (8x8 ->
14x14), clamp without a shift (4x4), pad without a shift and a
non-square size, a small SwinTransformer (embed 24, depths (1, 1, 2, 1)) at
128x160 with its gradients and remat, weight decay on the relative-position
table, and a Swin-T Unicorn (depth 0.33, width 0.5, one attention block a
level, 64x64) through forward_whole, with the weight bridge.

Parameters come from the port's seeded init and go to JAX through
unicorn_torch.convert (SWIN_BLOCK, to_flax); the Unicorn's tree is held
against the JAX model's own init tree (jax.eval_shape), and flax -> torch
-> flax is the identity.

Tolerances. fp32: atol 1e-4 on activations (as the port's other model
tests; flax's LayerNorm takes E[x^2] - E[x]^2). bf16: the bound of the bf16
deformable interaction, 2.5% of the output's |max| for the largest
difference and 0.5% for the mean (flax Dense adds its bias after a rounded
product; measured 1.1% / 0.18% at worst, on the small SwinTransformer). The
whole bf16 Unicorn is held to the bound tests/test_torch_port_model.py
holds the ConvNeXt Unicorn to, 5% and 1.5% (measured 4.1% / 0.84%).
Gradients: every entry within 1e-3 of its leaf's largest magnitude; remat
True against False within 1e-6 (the same ops run again).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unicorn_torch import convert
from unicorn_torch.core.train_state import default_wd_mask
from unicorn_torch.models import swin
from unicorn_torch.models.blocks import init_weights
from unicorn_torch.models.pafpn import build_backbone
from unicorn_torch.models.unicorn import Unicorn as TUnicorn
from unicorn_torch.models.unicorn import YOLOXDet
from unicorn_tpu.core.train_state import default_wd_mask as j_wd_mask
from unicorn_tpu.models import swin as jswin
from unicorn_tpu.models.unicorn import Unicorn as JUnicorn

DIM, HEADS = 24, 3
SMALL = dict(embed_dim=24, depths=(1, 1, 2, 1), num_heads=(3, 6, 12, 24))
CFG = dict(num_classes=8, backbone_name="swin_tiny", depth=0.33, width=0.5,
           in_channels=(192, 384, 768), n_layer_att=1)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(
        0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _nhwc(t):
    return t.float().permute(0, 2, 3, 1).detach().numpy()


def _np(t):
    return t.float().detach().numpy()


def _seeded(module, seed=0):
    init_weights(module, torch.Generator().manual_seed(seed))
    return module


def _put(tree, path, w):
    *parents, leaf = path.split("/")
    for part in parents:
        tree = tree.setdefault(part, {})
    tree[leaf] = w


def _block_tree(named):
    """torch names of a SwinBlock (or of its WindowAttention, prefixed
    "attn.") -> the flax tree."""
    table = {src: (dst, tf) for src, dst, tf in convert.SWIN_BLOCK}
    tree = {}
    for name, t in named.items():
        dst, tf = table[name]
        w = t.detach().float().numpy()
        _put(tree, dst, tf(w) if tf is not None else w)
    return tree


def _trunk_tree(named):
    """torch names of a SwinTransformer -> its flax tree."""
    return convert.to_flax({f"backbone.backbone.{k}": v for k, v in
                            named.items()})["backbone"]["SwinTransformer_0"]


def _leaves(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path): v
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_bf16(got, want, largest=0.025, mean=0.005):
    want = np.asarray(want).astype(np.float32)
    d = np.abs(got - want)
    scale = np.abs(want).max()
    assert d.max() <= largest * scale and d.mean() <= mean * scale, (
        d.max() / scale, d.mean() / scale)


def test_window_partition_and_reverse_match_jax():
    x = np.random.RandomState(0).randn(2, 14, 21, 5).astype(np.float32)
    got = swin.window_partition(torch.from_numpy(x), 7)
    want = jswin.window_partition(jnp.asarray(x), 7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = swin.window_reverse(got, 7, 14, 21)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jswin.window_reverse(want, 7, 14, 21)))


@pytest.mark.parametrize("ws", [2, 4, 7])
def test_relative_position_index_matches_jax(ws):
    """Inside the fixed 7-window table whatever the effective window."""
    got = swin.relative_position_index(ws, 7).numpy()
    np.testing.assert_array_equal(got, jswin.relative_position_index(ws, 7))
    assert got.shape == (ws * ws, ws * ws) and got.max() < 13 ** 2


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_window_attention_matches_jax(masked, dtype):
    ws, Hp, Wp = 4, 8, 12
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    attn = _seeded(swin.WindowAttention(DIM, HEADS, 7, dtype=tdt))
    tree = _block_tree({f"attn.{k}": v for k, v in
                        attn.state_dict().items()})["attn"]
    nW = (Hp // ws) * (Wp // ws)
    x = np.random.RandomState(1).randn(2 * nW, ws * ws, DIM).astype(
        np.float32)
    mask = swin.shift_mask(Hp, Wp, ws, 2) if masked else None
    want = jswin.WindowAttention(DIM, HEADS, ws, 7, dtype=jdt).apply(
        {"params": tree}, jnp.asarray(x, jdt),
        None if mask is None else jnp.asarray(mask.numpy()))
    if masked:
        assert (mask == -100).any() and (mask == 0).any()
    with torch.no_grad():
        got = attn(torch.from_numpy(x).to(tdt), ws, mask)
    assert got.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-4)
    else:
        _assert_bf16(_np(got), want)


@pytest.mark.parametrize("hw,shift", [
    ((8, 8), 3),      # window 7 with shift 3: padded to 14 x 14
    ((4, 4), 3),      # window clamps to 4 = min(H, W): no shift, no pad
    ((8, 8), 0),      # padded, unshifted: the padded tokens unmasked
    ((9, 16), 3),     # non-square: padded to 14 x 21
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swin_block_matches_jax(hw, shift, dtype):
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    block = _seeded(swin.SwinBlock(DIM, HEADS, 7, shift, dtype=tdt))
    tree = _block_tree(block.state_dict())
    x = np.random.RandomState(2).randn(2, *hw, DIM).astype(np.float32)
    want = jswin.SwinBlock(DIM, HEADS, 7, shift, dtype=jdt).apply(
        {"params": tree}, jnp.asarray(x, jdt))
    with torch.no_grad():
        got = block(torch.from_numpy(x).to(tdt))
    assert got.shape == x.shape and got.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-4)
    else:
        _assert_bf16(_np(got), want)


@pytest.fixture(scope="module")
def small():
    """The seeded small SwinTransformer, its flax tree and a 128x160
    image."""
    torch.set_num_threads(1)
    model = _seeded(swin.SwinTransformer(**SMALL))
    img = (np.random.RandomState(3).rand(1, 128, 160, 3) * 255).astype(
        np.float32)
    return model, _trunk_tree(model.state_dict()), img


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swin_transformer_matches_jax(small, dtype):
    model, tree, img = small
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    want = jax.jit(jswin.SwinTransformer(**SMALL, dtype=jdt).apply)(
        {"params": tree}, jnp.asarray(img))
    m = swin.SwinTransformer(**SMALL, dtype=tdt)
    m.load_state_dict(model.state_dict())
    with torch.no_grad():
        got = m(_nchw(img))
    assert len(got) == len(want) == 3
    for g, w, c, s in zip(got, want, (48, 96, 192), (8, 16, 32)):
        assert g.shape == (1, c, 128 // s, 160 // s) and g.dtype == tdt
        assert g.is_contiguous(memory_format=torch.channels_last)
        if dtype == "float32":
            np.testing.assert_allclose(_nhwc(g), np.asarray(w), atol=1e-4)
        else:
            _assert_bf16(_nhwc(g), w)


OFFSETS = [np.random.RandomState(5).randn(c).astype(np.float32)
           for c in (48, 96, 192)]


def _trunk_loss(outs):
    return sum(((o.float() + torch.from_numpy(w)[:, None, None]) ** 2).mean()
               for o, w in zip(outs, OFFSETS))


def _grads(model, img):
    model.zero_grad(set_to_none=True)
    loss = _trunk_loss(model(_nchw(img)))
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in
                         model.named_parameters()}


def test_swin_transformer_gradients_match_jax(small):
    model, tree, img = small
    loss, grads = _grads(model, img)
    jm = jswin.SwinTransformer(**SMALL)

    def j_loss(params):
        outs = jm.apply({"params": params}, jnp.asarray(img))
        return sum(jnp.mean((o + w) ** 2) for o, w in zip(outs, OFFSETS))

    j_total, j_grads = jax.jit(jax.value_and_grad(j_loss))(tree)
    assert abs(loss - float(j_total)) <= 1e-5 * abs(float(j_total))
    mine, want = _leaves(_trunk_tree(grads)), _leaves(j_grads)
    assert mine.keys() == want.keys() and len(want) == len(grads)
    for path, g in want.items():
        g = np.asarray(g)
        assert np.abs(mine[path] - g).max() <= 1e-3 * np.abs(g).max(), path


@pytest.mark.parametrize("remat", [True, "dw"])
def test_swin_remat_matches_no_remat(small, remat):
    """Any truthy remat is whole-block recomputation, the same numbers."""
    model, _, img = small
    loss, grads = _grads(model, img)
    m = swin.SwinTransformer(**SMALL, remat=remat)
    m.load_state_dict(model.state_dict())
    assert m.remat is True
    got_loss, got = _grads(m, img)
    assert abs(got_loss - loss) <= 1e-6 * abs(loss)
    for name, g in grads.items():
        assert float((got[name] - g).abs().max()) <= 1e-6 * float(
            g.abs().max()) + 1e-30, name


def test_relative_position_table_decays(small):
    """The port's weight-decay mask equals JAX's ndim > 1 rule on every
    leaf: the (169, heads) relative-position tables decay, the LayerNorms
    and biases do not."""
    model, tree, _ = small
    mask = default_wd_mask(model.named_parameters())
    tables = [n for n in mask if n.endswith("relative_position_bias_table")]
    assert len(tables) == 5 and all(mask[n] for n in tables)
    params = dict(model.named_parameters())
    mine = _leaves(_trunk_tree({n: torch.full_like(params[n], float(m))
                                for n, m in mask.items()}))
    want = _leaves(j_wd_mask(tree))
    assert mine.keys() == want.keys()
    for path, m in want.items():
        assert bool(mine[path].flat[0]) is bool(m), path
    assert "relative_position_index" not in model.state_dict()


def test_build_backbone_swin():
    """Every swin* name builds (one the table lacks is Swin-Tiny, as in
    the JAX package), and Unicorn / YOLOXDet build on them: the
    interaction's bottleneck takes the raw stride-16 width."""
    for name, (dim, depths) in {"swin_tiny": (96, [2, 2, 6, 2]),
                                "swin_small": (96, [2, 2, 18, 2]),
                                "swin_base": (128, [2, 2, 18, 2]),
                                "swin_large": (192, [2, 2, 18, 2]),
                                "swin_tiny_patch4_window7_224": (
                                    96, [2, 2, 6, 2])}.items():
        with torch.device("meta"):       # no memory for the large ones
            m, ch = build_backbone(name, remat=True)
        assert isinstance(m, swin.SwinTransformer) and m.remat
        assert m.patch_embed.proj.out_channels == dim
        assert [len(s.blocks) for s in m.layers] == depths
        assert ch == (2 * dim, 4 * dim, 8 * dim)
    tm = TUnicorn(**CFG)
    assert tm.backbone.raw_channels == (192, 384, 768)
    assert tm.bottleneck[0].in_channels == 384
    det = YOLOXDet(backbone_name="swin_tiny", width=0.5,
                   in_channels=(192, 384, 768), n_layer_att=1)
    assert isinstance(det.backbone.backbone, swin.SwinTransformer)


@pytest.fixture(scope="module")
def unicorn():
    """The seeded Swin-T Unicorn, its flax tree, and the JAX model's own
    init tree's shapes."""
    torch.set_num_threads(1)
    tm = TUnicorn(**CFG).eval()
    shapes = jax.eval_shape(
        functools.partial(JUnicorn(**CFG).init, method=JUnicorn.init_all),
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32))
    return tm, convert.to_flax(tm.state_dict()), shapes["params"]


def test_unicorn_bridge_round_trip(unicorn):
    """Every leaf of the JAX Swin-T Unicorn's tree is mapped exactly once,
    and flax -> torch -> flax is the identity."""
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
    assert sum(k.startswith("backbone/SwinTransformer_0/") for k in want) \
        == 175


def _whole(tree, img, dtype):
    return jax.jit(functools.partial(
        JUnicorn(**CFG, dtype=dtype).apply, method=JUnicorn.forward_whole))(
        {"params": tree}, jnp.asarray(img))


def test_unicorn_forward_whole_matches_jax(unicorn):
    tm, tree, _ = unicorn
    img = (np.random.RandomState(4).rand(1, 64, 64, 3) * 255).astype(
        np.float32)
    raw_j, f16_j = _whole(tree, img, jnp.float32)
    with torch.no_grad():
        raw_t, f16_t = tm.forward_whole(_nchw(img))
    assert f16_t.shape == (1, 384, 4, 4)
    np.testing.assert_allclose(_nhwc(f16_t), np.asarray(f16_j), atol=1e-4)
    for lj, lt in zip(raw_j, raw_t):
        assert set(lj) == set(lt)
        for key in lj:
            np.testing.assert_allclose(_nhwc(lt[key]), np.asarray(lj[key]),
                                       atol=1e-4, err_msg=key)
    raw_j, _ = _whole(tree, img, jnp.bfloat16)
    t = TUnicorn(**CFG, dtype=torch.bfloat16)
    t.load_state_dict(tm.state_dict())
    with torch.no_grad():
        raw_t, _ = t.eval().forward_whole(_nchw(img))
    for lj, lt in zip(raw_j, raw_t):
        for key in ("_cls_packed", "_reg_packed"):
            assert lt[key].dtype == torch.bfloat16
            _assert_bf16(_nhwc(lt[key]), lj[key], 0.05, 0.015)
