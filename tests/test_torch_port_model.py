"""The port's Unicorn (unicorn_torch) against the JAX package's, on the CPU.

A ConvNeXt-Tiny Unicorn with the PAFPN and head at width 0.5 (the
narrowest width whose GroupNorms divide: at 0.25 the JAX model itself
fails, 16 groups vs 24 channels) on 96x160 input. JAX params come from
Unicorn.init_all, go through unicorn_torch.convert.from_flax, and both
models see the same numpy images.

Tolerances. fp32: atol 1e-4 on outputs of |max| ~7 (measured ~3.5e-5); the
two sum in other orders, and flax's norms use E[x^2]-E[x]^2 where torch
centres first. bf16: the two frameworks round at other points (the JAX
dw7x7 reference rounds before and after its bias, flax Dense adds its bias
after a rounded product, XLA:CPU accumulates its bf16 convs in bf16), and
~30 blocks of random weights carry that; the bound is 5% of the output's
|max| for the largest difference and 1.5% for the mean (measured 3.1% and
0.8%).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tools.convert_torch_weights import convert_state_dict
from unicorn_torch.convert import from_flax
from unicorn_torch.models.heads import decode_for_inference as t_decode
from unicorn_torch.models.unicorn import Unicorn as TUnicorn
from unicorn_torch.ops.nms import postprocess_device as t_post
from unicorn_tpu.models.heads import decode_for_inference as j_decode
from unicorn_tpu.models.unicorn import Unicorn as JUnicorn
from unicorn_tpu.ops.nms import postprocess_device as j_post

H, W = 96, 160
CFG = dict(num_classes=8, backbone_name="convnext_tiny", width=0.5)
STRIDES = (8, 16, 32)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(1)
    rng = np.random.RandomState(0)
    imgs = (rng.rand(1, H, W, 3) * 255).astype(np.float32)
    jm = JUnicorn(**CFG)
    init = jax.jit(functools.partial(jm.init, method=JUnicorn.init_all))
    params = init(jax.random.PRNGKey(0), jnp.asarray(imgs))
    return imgs, params, from_flax(params)


def _torch_model(state, **kw):
    m = TUnicorn(**CFG, **kw)
    m.load_state_dict(state)
    return m.eval()


def _nchw(imgs):
    return torch.from_numpy(imgs).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _np(t):
    """NCHW torch tensor -> NHWC float32 numpy, as the JAX model lays out."""
    return t.float().permute(0, 2, 3, 1).numpy()


def _flax_leaves(params):
    return {"/".join(str(p.key) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(
                params["params"])}


def test_from_flax_round_trip_is_identity(setup):
    _, params, state = setup
    leaves = _flax_leaves(params)
    mapped, missed = convert_state_dict(
        {k: v.numpy() for k, v in state.items()})
    assert not missed
    assert set(mapped) == set(leaves)
    for path, w in mapped.items():
        np.testing.assert_array_equal(w, leaves[path], err_msg=path)
    assert {p.split("/")[0] for p in mapped} >= {
        "bottleneck", "upsample", "pos_emb", "interaction"}
    # the port's names are the state_dict's names, one to one
    assert set(TUnicorn(**CFG).state_dict()) == set(state)


@pytest.mark.parametrize("exact_gelu", [True, False])
def test_forward_backbone_matches_jax_fp32(setup, exact_gelu):
    imgs, params, state = setup
    jm = JUnicorn(**CFG, exact_gelu=exact_gelu)
    fpn_j, f16_j = jax.jit(functools.partial(
        jm.apply, method=JUnicorn.forward_backbone))(params, jnp.asarray(imgs))
    tm = _torch_model(state, exact_gelu=exact_gelu)
    with torch.no_grad():
        fpn_t, f16_t = tm.forward_backbone(_nchw(imgs))
        f16_only = tm.forward_backbone(_nchw(imgs), run_fpn=False)
    np.testing.assert_allclose(_np(f16_t), np.asarray(f16_j), atol=1e-4)
    np.testing.assert_array_equal(_np(f16_only), _np(f16_t))
    for a, b in zip(fpn_j, fpn_t):
        assert b.shape[1:] == (a.shape[3],) + a.shape[1:3]
        np.testing.assert_allclose(_np(b), np.asarray(a), atol=1e-4)


def _whole(params, imgs, dtype=jnp.float32, **kw):
    jm = JUnicorn(**CFG, dtype=dtype, **kw)
    return jax.jit(functools.partial(
        jm.apply, method=JUnicorn.forward_whole))(params, jnp.asarray(imgs))


@pytest.mark.parametrize("exact_gelu", [True, False])
def test_forward_whole_matches_jax_fp32(setup, exact_gelu):
    imgs, params, state = setup
    raw_j, f16_j = _whole(params, imgs, exact_gelu=exact_gelu)
    tm = _torch_model(state, exact_gelu=exact_gelu)
    with torch.no_grad():
        raw_t, f16_t = tm.forward_whole(_nchw(imgs))
    np.testing.assert_allclose(_np(f16_t), np.asarray(f16_j), atol=1e-4)
    for lj, lt in zip(raw_j, raw_t):
        assert set(lj) == set(lt)
        for key in lj:
            np.testing.assert_allclose(_np(lt[key]), np.asarray(lj[key]),
                                       atol=1e-4, err_msg=key)


def test_forward_whole_matches_jax_bf16(setup):
    imgs, params, state = setup
    raw_j, _ = _whole(params, imgs, dtype=jnp.bfloat16)
    tm = _torch_model(state, dtype=torch.bfloat16)
    with torch.no_grad():
        raw_t, _ = tm.forward_whole(_nchw(imgs))
    for lj, lt in zip(raw_j, raw_t):
        for key in ("_cls_packed", "_reg_packed"):
            assert lt[key].dtype == torch.bfloat16
            a = np.asarray(lj[key]).astype(np.float32)
            d = np.abs(_np(lt[key]) - a)
            scale = np.abs(a).max()
            assert d.max() <= 0.05 * scale and d.mean() <= 0.015 * scale


def test_decode_and_postprocess_match_jax(setup):
    imgs, params, state = setup
    raw_j, _ = _whole(params, imgs)
    tm = _torch_model(state)
    with torch.no_grad():
        raw_t, _ = tm.forward_whole(_nchw(imgs))
    dec_j = j_decode(raw_j, STRIDES, mode="mot")
    dec_t = t_decode(raw_t, STRIDES, mode="mot")
    np.testing.assert_allclose(dec_t.numpy(), np.asarray(dec_j),
                               rtol=1e-4, atol=1e-3)
    sot_j = j_decode(raw_j, STRIDES, mode="sot")
    sot_t = t_decode(raw_t, STRIDES, mode="sot")
    np.testing.assert_allclose(sot_t.numpy(), np.asarray(sot_j),
                               rtol=1e-4, atol=1e-3)
    kw = dict(num_classes=8, conf_thre=0.0, nms_thre=0.65, n_cand=512,
              max_out=128)
    dj, vj = j_post(dec_j, **kw)
    dt_, vt = t_post(dec_t, **kw)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_allclose(dt_.numpy(), np.asarray(dj), rtol=1e-4,
                               atol=1e-3)


def _synthetic_prediction(seed, B=2, A=400, C=3):
    """Crowded boxes (many overlaps), tied scores and low-score rows."""
    rng = np.random.RandomState(seed)
    cxcy = rng.uniform(20, 120, (B, A, 2))
    wh = rng.uniform(10, 40, (B, A, 2))
    obj = rng.choice([0.3, 0.5, 0.9, 0.95], (B, A, 1))
    cls = rng.uniform(0, 1, (B, A, C))
    cls[:, ::7] = 0.5  # ties in score
    return np.concatenate([cxcy, wh, obj, cls], -1).astype(np.float32)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(class_agnostic=True),
    dict(cluster_iters=2),
    dict(cluster_iters=50, conf_thre=0.2),
    dict(n_cand=64, max_out=16, nms_thre=0.3),
    dict(num_classes=1, class_agnostic=True, conf_thre=0.001, nms_thre=0.65,
         max_out=3),                      # as the SOT driver calls it
], ids=["greedy", "agnostic", "cluster2", "cluster50", "small", "sot"])
def test_postprocess_device_matches_jax(kw):
    pred = _synthetic_prediction(0)
    args = dict(num_classes=3, conf_thre=0.1, nms_thre=0.5, n_cand=256,
                max_out=100, return_idx=True)
    args.update(kw)
    dj, vj, ij = j_post(jnp.asarray(pred), **args)
    dt_, vt, it = t_post(torch.from_numpy(pred), **args)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt_.numpy(), np.asarray(dj), rtol=1e-6,
                               atol=1e-5)
    assert vt.sum() > 0


def test_from_flax_reports_only_the_mask_branch():
    """A tree with the mask stack (shapes only, zeros for values): every
    leaf converts now, the mask branch and the controllers included, and
    the port's model with the mask stack holds exactly those names."""
    jm = JUnicorn(**CFG, use_mask=True)
    shapes = jax.eval_shape(
        functools.partial(jm.init, method=JUnicorn.init_all),
        jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3), jnp.float32))
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                    shapes)
    state = from_flax(params)
    assert len(state) == len(_flax_leaves(params))
    assert "transformer.level_embed" in state
    assert "upsample_layer.3.bias" in state
    assert "head.mask_branch.tower.4.weight" in state
    assert "head.controllers.2.weight" in state
    assert set(TUnicorn(**CFG, use_mask=True).state_dict()) == set(state)


def test_constructor_fields_not_ported_raise():
    # the Swin and ResNet-50 trunks are ported now: they build
    for kw, trunk in ((dict(backbone_name="swin_tiny"), "SwinTransformer"),
                      (dict(backbone_name="resnet50"), "ResNet50")):
        m = TUnicorn(**{**CFG, **kw})
        assert type(m.backbone.backbone).__name__ == trunk
    # backbone remat is ported: the trunk's blocks take the mode, the
    # head's attention blocks do not; any other mode is refused
    for remat in (True, "dw"):
        m = TUnicorn(**CFG, remat=remat)
        assert {b.remat for s in m.backbone.backbone.stages for b in s} \
            == {remat}
        assert not any(getattr(b, "remat", False)
                       for b in m.head.modules() if b is not m.head)
    with pytest.raises(ValueError):
        TUnicorn(**CFG, remat="mlp")
    # the mask stack, the other interaction modes and CSPDarknet are
    # ported now
    m = TUnicorn(**CFG, use_mask=True, use_raft=True, up_rate=4,
                 interact_mode="full")
    assert m.head.mask_branch.up_mask_layer[2].out_channels == 9 * 16
    assert type(m.transformer).__name__ == "FullAttentionInteraction"
    with pytest.raises(ValueError):
        TUnicorn(**CFG, interact_dtype=torch.float16)
    # the fields of this slice are taken
    m = TUnicorn(**CFG, embed_dim=64, hidden_dim=128,
                 interact_dtype=torch.bfloat16)
    assert m.upsample_layer[3].out_channels == 64
    assert m.bottleneck[0].out_channels == 128


def test_space_to_depth_and_packed_stem_match_jax():
    from unicorn_torch.models.convnext import (PatchEmbed4x4,
                                               space_to_depth_4x4)
    from unicorn_tpu.models.convnext import space_to_depth_4x4 as j_s2d

    rng = np.random.RandomState(3)
    x = rng.rand(2, 16, 24, 3).astype(np.float32)
    packed = space_to_depth_4x4(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(packed, np.asarray(j_s2d(jnp.asarray(x))))
    stem = PatchEmbed4x4(8)
    with torch.no_grad():
        stem.weight.copy_(torch.from_numpy(rng.randn(8, 3, 4, 4)
                                           .astype(np.float32)))
        stem.bias.copy_(torch.from_numpy(rng.randn(8).astype(np.float32)))
        y_img = stem(torch.from_numpy(x).permute(0, 3, 1, 2))
        y_pack = stem(torch.from_numpy(packed).permute(0, 3, 1, 2))
        # the 4x4/4 conv the stem stands for
        y_conv = torch.nn.functional.conv2d(
            torch.from_numpy(x).permute(0, 3, 1, 2), stem.weight, stem.bias,
            stride=4)
    np.testing.assert_array_equal(y_img.numpy(), y_pack.numpy())
    np.testing.assert_allclose(y_img.numpy(), y_conv.numpy(), atol=1e-5)
    with pytest.raises(ValueError):
        stem(torch.zeros(1, 5, 8, 8))


def test_upsample_and_level_grids_match_jax():
    from unicorn_torch.models.blocks import upsample_nearest_2x
    from unicorn_torch.models.heads import level_grids
    from unicorn_tpu.models.blocks import upsample_nearest_2x as j_up
    from unicorn_tpu.models.heads import level_grids as j_grids

    x = np.random.RandomState(4).rand(2, 3, 5, 6).astype(np.float32)
    up = upsample_nearest_2x(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(_np(up), np.asarray(j_up(jnp.asarray(x))))
    hw = [(12, 20), (6, 10), (3, 5)]
    for a, b in zip(level_grids(hw, STRIDES), j_grids(hw, STRIDES)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_approx_topk_is_tpu_only():
    pred = torch.from_numpy(_synthetic_prediction(1))
    with pytest.raises(NotImplementedError):
        t_post(pred, num_classes=3, approx_topk=True)
