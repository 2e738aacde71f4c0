"""The port's SOT path (unicorn_torch) against the JAX package's, on the CPU:
each interaction module against its flax counterpart from the same
parameters, forward_interaction + forward_upsample in fp32 and with bf16
interaction, and SOTDriver end to end on a short synthetic clip.

A ConvNeXt-Tiny Unicorn with the PAFPN and head at width 0.5 on 96x160
frames (the stride-16 map is 6x10, so the 40x40 position embedding is
resized down; the module test also resizes it up to 50x80).

Tolerances. fp32: atol 1e-4 on activations of |max| ~5, for other summation
orders and flax's E[x^2]-E[x]^2 norms. bf16 interaction: the two frameworks
round at other points (flax Dense adds its bias after a rounded product,
jax.nn.softmax works in bf16, torch's in fp32), through a 1x1 conv, five
Dense layers and two 3x3 convs: the bound is 2.5% of the output's |max| for
the largest difference and 0.5% for the mean (measured 0.8% and 0.09%).
Driver: boxes within 1e-2 px and scores within 1e-4 of the JAX driver's
(measured 5e-4 px and 4e-7).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unicorn_torch.convert import from_flax
from unicorn_torch.drivers.sot import SOTDriver as TSOTDriver
from unicorn_torch.exp.unicorn_track_tiny import Exp as TExp
from unicorn_torch.models.unicorn import Unicorn as TUnicorn
from unicorn_tpu.drivers.sot import SOTDriver as JSOTDriver
from unicorn_tpu.models import interaction as ji
from unicorn_tpu.models.unicorn import Unicorn as JUnicorn

H, W = 96, 160
CFG = dict(num_classes=8, backbone_name="convnext_tiny", width=0.5)
INIT_BOX = [40, 20, 36, 30]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(1)
    rng = np.random.RandomState(0)
    base = (rng.rand(H, W + 16, 3) * 255).astype(np.uint8)
    frames = [np.ascontiguousarray(base[:, 2 * t:2 * t + W])
              for t in range(5)]
    jm = JUnicorn(**CFG)
    init = jax.jit(functools.partial(jm.init, method=JUnicorn.init_all))
    params = init(jax.random.PRNGKey(2),
                  jnp.asarray(frames[0][None], jnp.float32))
    state = from_flax(params)
    # the stride-16 features of two frames, from the port's own trunk
    tm = _torch_model(state)
    with torch.no_grad():
        feats = [tm.forward_backbone(_nchw(f[None].astype(np.float32)),
                                     run_fpn=False) for f in frames[:2]]
    return dict(frames=frames, params=params, state=state, feats=feats)


def _torch_model(state, **kw):
    m = TUnicorn(**CFG, **kw)
    m.load_state_dict(state)
    return m.eval()


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


def _sub(params, name):
    return {"params": params["params"][name]}


@pytest.mark.parametrize("hw", [(6, 10), (50, 80)])
def test_position_embedding_matches_flax(setup, hw):
    tm = _torch_model(setup["state"])
    out_j = ji.PositionEmbeddingLearned(128, sz=40).apply(
        _sub(setup["params"], "pos_emb"), 2, *hw)
    with torch.no_grad():
        out_t = tm.pos_emb(2, *hw)
    assert tuple(out_t.shape) == (2, 256) + hw
    np.testing.assert_allclose(_nhwc(out_t), np.asarray(out_j), atol=1e-5)


def test_bottleneck_matches_flax(setup):
    tm = _torch_model(setup["state"])
    f = setup["feats"][0]
    out_j = ji.Bottleneck1x1(256).apply(_sub(setup["params"], "bottleneck"),
                                        jnp.asarray(_nhwc(f)))
    with torch.no_grad():
        out_t = tm.bottleneck(f)
    np.testing.assert_allclose(_nhwc(out_t), np.asarray(out_j), atol=1e-4)


def test_upsample_embed_matches_flax(setup):
    tm = _torch_model(setup["state"])
    x = np.random.RandomState(1).randn(2, 6, 10, 256).astype(np.float32)
    out_j = ji.UpsampleEmbed(128, 256).apply(_sub(setup["params"], "upsample"),
                                             jnp.asarray(x))
    with torch.no_grad():
        out_t = tm.upsample_layer(_nchw(x))
    assert tuple(out_t.shape) == (2, 128, 12, 20)
    np.testing.assert_allclose(_nhwc(out_t), np.asarray(out_j), atol=1e-4)


def test_pixel_shuffle_and_interpolate_match_jax():
    from unicorn_torch.models import blocks as tb
    from unicorn_tpu.models import blocks as jb

    x = np.random.RandomState(2).rand(2, 5, 7, 12).astype(np.float32)
    np.testing.assert_array_equal(
        _nhwc(tb.pixel_shuffle_2x(_nchw(x))),
        np.asarray(jb.pixel_shuffle_2x(jnp.asarray(x))))
    for hw in ((3, 4), (11, 13)):
        np.testing.assert_allclose(
            _nhwc(tb.interpolate_bilinear(_nchw(x), *hw)),
            np.asarray(jb.interpolate_bilinear(jnp.asarray(x), *hw)),
            atol=1e-6)


def test_deformable_interaction_matches_flax(setup):
    """Random offsets and attention logits in place of the zero-initialised
    kernels, so that the sampling really depends on the query."""
    rng = np.random.RandomState(3)
    sub = jax.tree_util.tree_map(np.asarray, _sub(setup["params"],
                                                  "interaction"))
    layer = sub["params"]["layer0"]
    for name, s in (("sampling_offsets", 0.05), ("attention_weights", 0.5)):
        k = layer[name]["kernel"]
        layer[name]["kernel"] = (rng.randn(*k.shape) * s).astype(np.float32)
    tm = _torch_model(setup["state"])
    att = tm.transformer.encoder.layers[0].self_attn
    with torch.no_grad():
        for name in ("sampling_offsets", "attention_weights"):
            getattr(att, name).weight.copy_(
                torch.from_numpy(layer[name]["kernel"].T))
    feats = rng.randn(2, 2, 6, 10, 256).astype(np.float32)
    pos = rng.rand(2, 6, 10, 256).astype(np.float32)
    out_j = ji.DeformableInteraction(256).apply(
        sub, tuple(jnp.asarray(f) for f in feats),
        (jnp.asarray(pos), jnp.asarray(pos)))
    with torch.no_grad():
        out_t = tm.transformer(tuple(_nchw(f) for f in feats),
                               (_nchw(pos), _nchw(pos)))
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(_nhwc(a), np.asarray(b), atol=1e-4)


def test_offset_bias_init_matches_flax():
    from unicorn_torch.models.interaction import offset_bias_init

    ref = ji._offset_bias_init(8, 2, 4)(None, None)
    np.testing.assert_allclose(offset_bias_init(8, 2, 4).numpy(),
                               np.asarray(ref), atol=1e-6)
    m = TUnicorn(**CFG)   # the port's own init applies it
    att = m.transformer.encoder.layers[0].self_attn
    np.testing.assert_allclose(att.sampling_offsets.bias.detach().numpy(),
                               np.asarray(ref), atol=1e-6)
    assert not att.sampling_offsets.weight.any()
    assert not att.attention_weights.weight.any()
    emb = m.pos_emb.col_embed.weight.detach()
    assert 0.0 <= float(emb.min()) and float(emb.max()) < 1.0


def _interaction_jax(params, feats, interact_dtype):
    jm = JUnicorn(**CFG, interact_dtype=interact_dtype)

    def fn(p, f0, f1):
        n0, n1 = jm.apply(p, f0, f1, method=JUnicorn.forward_interaction)
        return (n0, n1,
                jm.apply(p, n0, method=JUnicorn.forward_upsample),
                jm.apply(p, n1, method=JUnicorn.forward_upsample))

    return jax.jit(fn)(params, *(jnp.asarray(_nhwc(f)) for f in feats))


def _interaction_torch(tm, feats):
    with torch.no_grad():
        n0, n1 = tm.forward_interaction(*feats)
        return n0, n1, tm.forward_upsample(n0), tm.forward_upsample(n1)


def test_forward_interaction_and_upsample_match_jax_fp32(setup):
    outs_j = _interaction_jax(setup["params"], setup["feats"], jnp.float32)
    outs_t = _interaction_torch(_torch_model(setup["state"]), setup["feats"])
    for a, b in zip(outs_t, outs_j):
        assert a.shape[1:] == (b.shape[3],) + b.shape[1:3]
        np.testing.assert_allclose(_nhwc(a), np.asarray(b), atol=1e-4)


def test_forward_interaction_and_upsample_match_jax_bf16(setup):
    outs_j = _interaction_jax(setup["params"], setup["feats"], jnp.bfloat16)
    tm = _torch_model(setup["state"], interact_dtype=torch.bfloat16)
    outs_t = _interaction_torch(tm, setup["feats"])
    for a, b in zip(outs_t, outs_j):
        assert a.dtype == torch.bfloat16
        ref = np.asarray(b).astype(np.float32)
        d = np.abs(_nhwc(a) - ref)
        scale = np.abs(ref).max()
        assert d.max() <= 0.025 * scale and d.mean() <= 0.005 * scale


def test_sampling_locations_are_fp32_under_bf16_interaction(setup):
    """The offsets come out of a bf16 Linear, the reference points and the
    normaliser are fp32: the locations promote to fp32, as in JAX, while
    the attention weights stay bf16 and are a softmax over L*P jointly."""
    tm = _torch_model(setup["state"], interact_dtype=torch.bfloat16)
    layer = tm.transformer.encoder.layers[0]
    src = torch.randn(1, 2 * 6 * 10, 256, generator=torch.Generator()
                      .manual_seed(0)).bfloat16()
    with torch.no_grad():
        value, locs, attw = layer.sampling(src, src, 6, 10)
    assert value.dtype == torch.bfloat16 and attw.dtype == torch.bfloat16
    assert locs.dtype == torch.float32
    assert tuple(value.shape) == (1, 2, 6, 10, 8, 32)
    assert tuple(locs.shape) == (1, 120, 8, 2, 4, 2)
    np.testing.assert_allclose(attw.float().sum((-1, -2)).numpy(), 1.0,
                               atol=2e-2)


def test_forward_head_with_priors_matches_jax(setup):
    """The head with non-zero target priors (the beta-scaled sum fusion)."""
    rng = np.random.RandomState(4)
    tm = _torch_model(setup["state"])
    img = _nchw(setup["frames"][1][None].astype(np.float32))
    with torch.no_grad():
        fpn_t, _ = tm.forward_backbone(img)
        priors = [rng.rand(1, 1, *f.shape[2:]).astype(np.float32)
                  for f in fpn_t]
        raw_t = tm.forward_head(fpn_t, tuple(map(torch.from_numpy, priors)))
    jm = JUnicorn(**CFG)
    raw_j = jax.jit(functools.partial(jm.apply, method=JUnicorn.forward_head))(
        setup["params"], tuple(jnp.asarray(_nhwc(f)) for f in fpn_t),
        tuple(jnp.asarray(p.transpose(0, 2, 3, 1)) for p in priors))
    with torch.no_grad():
        zero_t = tm.forward_head(fpn_t, tuple(
            torch.zeros_like(torch.from_numpy(p)) for p in priors))
    for lj, lt, lz in zip(raw_j, raw_t, zero_t):
        for key in ("cls_sot", "reg_sot", "obj_sot", "_cls_packed",
                    "_reg_packed"):
            np.testing.assert_allclose(_nhwc(lt[key]), np.asarray(lj[key]),
                                       atol=1e-4, err_msg=key)
        assert (lt["reg_sot"] - lz["reg_sot"]).abs().max() > 1e-3


def test_sot_driver_matches_jax_driver(setup):
    """Frames already at the input size (the letterbox is the identity):
    the packed detections and the tracked box of every frame, in fp32."""
    frames = setup["frames"]
    jm = JUnicorn(**CFG)
    kw = dict(input_size=(H, W), conf_thre=0.0, max_inst=3)
    dj = JSOTDriver(jm, setup["params"], **kw)
    dt_ = TSOTDriver(_torch_model(setup["state"]), device="cpu", **kw)
    dj.initialize(frames[0], INIT_BOX)
    dt_.initialize(frames[0], INIT_BOX)
    np.testing.assert_allclose(_nhwc(dt_.feat_ref), np.asarray(dj.feat_ref),
                               atol=1e-4)
    np.testing.assert_allclose(dt_.lbs_ref.numpy(), np.asarray(dj.lbs_ref),
                               atol=1e-6)
    assert float(dt_.lbs_ref.sum()) > 0
    for f in frames[1:]:
        frame_j, r = dj._preproc_u8(f)
        packed_j = np.asarray(dj._track_fn(dj.params, dj.feat_ref,
                                           dj.lbs_ref, frame_j))
        img, r_t = dt_.preprocess(f)
        packed_t = dt_.postprocess(dt_.forward(img))[0].numpy()
        assert r == r_t == 1.0
        assert packed_t.shape == packed_j.shape == (3, 8)
        np.testing.assert_array_equal(packed_t[:, 6:], packed_j[:, 6:])
        assert packed_t[:, 7].sum() > 0
        np.testing.assert_allclose(packed_t[:, :4], packed_j[:, :4],
                                   atol=1e-2)
        np.testing.assert_allclose(packed_t[:, 4:6], packed_j[:, 4:6],
                                   atol=1e-4)
        np.testing.assert_allclose(dt_.track(f)["target_bbox"],
                                   dj.track(f)["target_bbox"], atol=1e-2)
    assert dt_.frame_id == dj.frame_id == 4


def test_track_window_matches_sequential_track(setup):
    """Windows of 3 over 4 frames: one full chunk and a padded tail."""
    frames = setup["frames"]
    tm = _torch_model(setup["state"])
    kw = dict(input_size=(H, W), conf_thre=0.0, device="cpu")
    d1, d2 = TSOTDriver(tm, **kw), TSOTDriver(tm, **kw)
    small = [f[::2, ::2] for f in frames]    # 48x80: a real letterbox, r = 2
    d1.initialize(small[0], INIT_BOX)
    d2.initialize(small[0], INIT_BOX)
    seq = [d1.track(f)["target_bbox"] for f in small[1:]]
    win = [o["target_bbox"] for o in d2.track_window(small[1:], window=3)]
    assert len(win) == 4 and d2.frame_id == 4
    np.testing.assert_allclose(np.asarray(win), np.asarray(seq), rtol=1e-4,
                               atol=1e-3)
    assert all(np.isfinite(b).all() and b[2] > 0 and b[3] > 0 for b in win)


def test_update_state_from_packed_matches_jax():
    state = [1.0, 2.0, 3.0, 4.0]
    empty = np.zeros((3, 8), np.float32)
    full = empty.copy()
    full[0] = [-5.0, 10.0, 200.0, 120.0, 0.9, 0.8, 0.0, 1.0]   # clamped
    full[1] = [1.0, 1.0, 2.0, 2.0, 0.5, 0.5, 0.0, 1.0]
    for packed in (empty, full):
        a = TSOTDriver.update_state_from_packed(packed, 0.5, state, (H, W))
        b = JSOTDriver.update_state_from_packed(packed, 0.5, state, (H, W))
        assert a == b
    assert TSOTDriver.update_state_from_packed(empty, 0.5, state,
                                               (H, W)) is state
    assert a == [0.0, 20.0, 320.0, 172.0]


def test_sot_driver_needs_a_card_unless_asked_for_the_cpu(setup):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TSOTDriver(_torch_model(setup["state"]), input_size=(H, W))


def test_served_model_has_bf16_interaction():
    exp = TExp()
    exp.width = 0.5                      # narrow PAFPN and head: a fast build
    assert exp.serve_interact_bf16
    served = exp.get_model(serve=True, msda_method="pallas")
    assert served.interact_dtype == torch.bfloat16
    assert served.dtype == torch.bfloat16
    assert served.transformer.encoder.layers[0].msda_method == "pallas"
    assert served.bottleneck[0].dtype == torch.bfloat16
    assert exp.get_model().interact_dtype == torch.float32
    exp.serve_interact_bf16 = False
    assert exp.get_model(serve=True).interact_dtype == torch.float32
