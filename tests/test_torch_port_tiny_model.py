"""The JAX tests' tiny Unicorn in the port (unicorn_torch) against the JAX
package's, on the CPU: CSPDarknet at depth 0.33 and width 0.25 with the
PAFPN and the head, no attention blocks, 64x64 input, the "conv" and
"full" interaction modes, and SOTDriver on the "conv" model as
tests/test_drivers.py builds it.

Parameters come from the port's own seeded init and go to JAX through
unicorn_torch.convert.to_flax; the tree they make is held against the JAX
model's own init tree (paths and shapes, from jax.eval_shape, which traces
without compiling), and flax -> torch -> flax is held to be the identity.

Tolerances, PR 2's. fp32: atol 1e-4 on activations of |max| up to ~10 (the
two sum in other orders; flax's norms take E[x^2]-E[x]^2). bf16 "full"
interaction: the bound of the bf16 deformable interaction, 2.5% of the
output's |max| for the largest difference and 0.5% for the mean (flax's
softmax runs in bf16, the port's SDPA in fp32 before it rounds; flax Dense
adds its bias after a rounded product). Driver: boxes within 1e-2 px and
scores within 1e-4 of the JAX driver's.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unicorn_torch.convert import from_flax, to_flax
from unicorn_torch.drivers.sot import SOTDriver as TSOTDriver
from unicorn_torch.models.unicorn import Unicorn as TUnicorn
from unicorn_tpu.drivers.sot import SOTDriver as JSOTDriver
from unicorn_tpu.models.unicorn import Unicorn as JUnicorn

H = W = 64
DEPTH = 0.33
# tests/test_drivers.py:14-17
CFG = dict(num_classes=1, backbone_name="csp_darknet", depth=DEPTH,
           width=0.25, in_channels=(256, 512, 1024), n_layer_att=0,
           use_attention=False)
MODES = ("conv", "full")
INIT_BOX = [16, 12, 24, 20]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(
        0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


def _leaves(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path): v
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def build(mode, generator_seed=0, **kw):
    """(torch model, flax params of the same weights, JAX model)."""
    cfg = dict(CFG, interact_mode=mode, **kw)
    tm = TUnicorn(**cfg, generator=torch.Generator().manual_seed(
        generator_seed)).eval()
    return tm, {"params": to_flax(tm.state_dict())}, \
        JUnicorn(**cfg)


@pytest.fixture(scope="module")
def models():
    torch.set_num_threads(1)
    rng = np.random.RandomState(0)
    imgs = (rng.rand(1, H, W, 3) * 255).astype(np.float32)
    return {"imgs": imgs, **{mode: build(mode, k)
                             for k, mode in enumerate(MODES)}}


@pytest.mark.parametrize("mode", MODES)
def test_flax_torch_flax_round_trip_is_identity(models, mode):
    tm, params, jm = models[mode]
    shapes = jax.eval_shape(functools.partial(jm.init,
                                              method=JUnicorn.init_all),
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, H, W, 3), jnp.float32))
    ref = {k: v.shape for k, v in _leaves(shapes["params"]).items()}
    got = _leaves(params["params"])
    assert {k: v.shape for k, v in got.items()} == ref
    assert any(k.startswith("backbone/CSPDarknet_0/SPPBottleneck_0/")
               for k in got)
    state = from_flax(params)
    assert set(state) == set(tm.state_dict())
    back = _leaves(to_flax(state))
    assert set(back) == set(got)
    for k, v in got.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    for k, v in tm.state_dict().items():
        assert torch.equal(state[k], v), k


def test_forward_whole_matches_jax_fp32(models):
    tm, params, jm = models["conv"]
    imgs = models["imgs"]
    raw_j, f16_j = jax.jit(functools.partial(
        jm.apply, method=JUnicorn.forward_whole))(params, jnp.asarray(imgs))
    fpn_j, _ = jax.jit(functools.partial(
        jm.apply, method=JUnicorn.forward_backbone))(params, jnp.asarray(imgs))
    with torch.no_grad():
        raw_t, f16_t = tm.forward_whole(_nchw(imgs))
        fpn_t, _ = tm.forward_backbone(_nchw(imgs))
    assert tuple(f16_t.shape) == (1, 128, H // 16, W // 16)
    np.testing.assert_allclose(_nhwc(f16_t), np.asarray(f16_j), atol=1e-4)
    for a, b in zip(fpn_t, fpn_j):
        np.testing.assert_allclose(_nhwc(a), np.asarray(b), atol=1e-4)
    for lj, lt in zip(raw_j, raw_t):
        assert set(lj) == set(lt)
        for key in lj:
            np.testing.assert_allclose(_nhwc(lt[key]), np.asarray(lj[key]),
                                       atol=1e-4, err_msg=key)


def _interaction_jax(jm, params, f0, f1):
    def fn(p, a, b):
        n0, n1 = jm.apply(p, a, b, method=JUnicorn.forward_interaction)
        return n0, n1, jm.apply(p, n1, method=JUnicorn.forward_upsample)

    return jax.jit(fn)(params, jnp.asarray(_nhwc(f0)), jnp.asarray(_nhwc(f1)))


@pytest.mark.parametrize("mode", MODES)
def test_forward_interaction_matches_jax_fp32(models, mode):
    """Two frames' stride-16 features from the port's CSP trunk (full: 32
    tokens over both frames, with the 40x40 position table resized to
    4x4)."""
    tm, params, jm = models[mode]
    rng = np.random.RandomState(1)
    with torch.no_grad():
        feats = [tm.forward_backbone(_nchw((rng.rand(1, H, W, 3) * 255)
                                           .astype(np.float32)),
                                     run_fpn=False) for _ in range(2)]
        outs_t = tm.forward_interaction(*feats)
        outs_t = (*outs_t, tm.forward_upsample(outs_t[1]))
    assert (tm.pos_emb is None) == (mode == "conv")
    outs_j = _interaction_jax(jm, params, *feats)
    assert tuple(outs_t[2].shape) == (1, 128, H // 8, W // 8)
    for a, b in zip(outs_t, outs_j):
        np.testing.assert_allclose(_nhwc(a), np.asarray(b), atol=1e-4)
    # the two frames interact: the first frame's output moves with the
    # second frame's feature in "full" mode, and not in "conv" mode
    with torch.no_grad():
        moved = tm.forward_interaction(feats[0], feats[0])[0]
    assert bool((moved - outs_t[0]).abs().max() > 1e-3) == (mode == "full")


def test_full_interaction_matches_jax_bf16(models):
    tm, params, _ = models["full"]
    jm = JUnicorn(**CFG, interact_mode="full", interact_dtype=jnp.bfloat16)
    tb = TUnicorn(**CFG, interact_mode="full",
                  interact_dtype=torch.bfloat16).eval()
    tb.load_state_dict(tm.state_dict())
    rng = np.random.RandomState(2)
    feats = [torch.from_numpy(rng.randn(1, 128, H // 16, W // 16)
                              .astype(np.float32)) for _ in range(2)]
    with torch.no_grad():
        outs_t = tb.forward_interaction(*feats)
        outs_t = (*outs_t, tb.forward_upsample(outs_t[1]))
    outs_j = _interaction_jax(jm, params, *feats)
    for a, b in zip(outs_t, outs_j):
        assert a.dtype == torch.bfloat16
        ref = np.asarray(b).astype(np.float32)
        d = np.abs(_nhwc(a) - ref)
        scale = np.abs(ref).max()
        assert d.max() <= 0.025 * scale and d.mean() <= 0.005 * scale


def test_sot_driver_on_the_conv_model_matches_jax(models):
    """Frames at the input size (the letterbox is the identity): the
    packed detections and the tracked box of every frame, in fp32."""
    tm, params, jm = models["conv"]
    rng = np.random.RandomState(0)
    base = (rng.rand(H, W + 8, 3) * 255).astype(np.uint8)
    frames = [np.ascontiguousarray(base[:, 2 * t:2 * t + W])
              for t in range(4)]
    kw = dict(input_size=(H, W), conf_thre=0.0, max_inst=3)
    dj = JSOTDriver(jm, params, **kw)
    dt_ = TSOTDriver(tm, device="cpu", **kw)
    dj.initialize(frames[0], INIT_BOX)
    dt_.initialize(frames[0], INIT_BOX)
    np.testing.assert_allclose(_nhwc(dt_.feat_ref), np.asarray(dj.feat_ref),
                               atol=1e-4)
    np.testing.assert_allclose(dt_.lbs_ref.numpy(), np.asarray(dj.lbs_ref),
                               atol=1e-6)
    for f in frames[1:]:
        frame_j, r = dj._preproc_u8(f)
        packed_j = np.asarray(dj._track_fn(dj.params, dj.feat_ref,
                                           dj.lbs_ref, frame_j))
        img, r_t = dt_.preprocess(f)
        packed_t = dt_.postprocess(dt_.forward(img))[0].numpy()
        assert r == r_t == 1.0
        np.testing.assert_array_equal(packed_t[:, 6:], packed_j[:, 6:])
        assert packed_t[:, 7].sum() > 0
        np.testing.assert_allclose(packed_t[:, :4], packed_j[:, :4],
                                   atol=1e-2)
        np.testing.assert_allclose(packed_t[:, 4:6], packed_j[:, 4:6],
                                   atol=1e-4)
        box_t, box_j = dt_.track(f)["target_bbox"], dj.track(f)["target_bbox"]
        np.testing.assert_allclose(box_t, box_j, atol=1e-2)
        assert np.isfinite(box_t).all() and box_t[2] > 0 and box_t[3] > 0


def _base_conv_flax(m):
    """The flax sub-tree of one port BaseConv."""
    return {"Conv_0": {"kernel": m.conv.weight.detach().numpy()
                       .transpose(2, 3, 1, 0)},
            "GroupNorm32_0": {"GroupNorm_0": {
                "scale": m.bn.weight.detach().numpy(),
                "bias": m.bn.bias.detach().numpy()}}}


def test_focus_order_and_spp_pools_match_flax():
    """Focus's space-to-depth order (top-left, bottom-left, top-right,
    bottom-right) and SPP's -inf-padded stride-1 pools, module by module,
    on odd-sized maps."""
    from unicorn_torch.models import blocks as tb
    from unicorn_tpu.models import blocks as jb

    rng = np.random.RandomState(3)
    focus = tb.Focus(3, 8, ksize=3).eval()
    spp = tb.SPPBottleneck(8, 6).eval()
    tb.init_weights(focus, torch.Generator().manual_seed(3))
    tb.init_weights(spp, torch.Generator().manual_seed(4))
    x = rng.randn(2, 10, 12, 3).astype(np.float32)
    x8 = rng.randn(2, 7, 9, 8).astype(np.float32)
    with torch.no_grad():
        yf, ys = focus(_nchw(x)), spp(_nchw(x8))
    yf_j = jb.Focus(8, ksize=3).apply(
        {"params": {"BaseConv_0": _base_conv_flax(focus.conv)}},
        jnp.asarray(x))
    ys_j = jb.SPPBottleneck(6).apply(
        {"params": {"BaseConv_0": _base_conv_flax(spp.conv1),
                    "BaseConv_1": _base_conv_flax(spp.conv2)}},
        jnp.asarray(x8))
    assert tuple(yf.shape) == (2, 8, 5, 6)
    np.testing.assert_allclose(_nhwc(yf), np.asarray(yf_j), atol=1e-4)
    np.testing.assert_allclose(_nhwc(ys), np.asarray(ys_j), atol=1e-4)


def test_constructor_modes():
    tm = TUnicorn(**CFG, interact_mode="conv")
    assert tm.pos_emb is None
    assert type(tm.transformer).__name__ == "ConvInteraction"
    assert type(TUnicorn(**CFG, interact_mode="full").transformer
                ).__name__ == "FullAttentionInteraction"
    with pytest.raises(ValueError):
        TUnicorn(**CFG, interact_mode="dense")
    # the Swin and ResNet-50 trunks are ported now: they build
    for name, trunk in (("swin_tiny", "SwinTransformer"),
                        ("resnet50", "ResNet50")):
        tm = TUnicorn(**dict(CFG, backbone_name=name))
        assert type(tm.backbone.backbone).__name__ == trunk
