"""The port's CondInst mask stack (unicorn_torch) against the JAX package's,
on the CPU: each ops.dynamic_conv function, MaskBranch with and without
the RAFT up-mask, the head's controllers, YOLOXDet(use_mask=True) and
make_inst_forward on the JAX mask tests' detection model
(tests/test_mask_stage.py:70-73: CSPDarknet depth 0.33 width 0.25, five
classes, 64x64), Unicorn(use_mask=True, use_raft=True, up_rate=4)'s mask
branch, and one bf16 case on ConvNeXt-Tiny width 0.5 at 96x160.

Parameters come from the port's seeded init and reach JAX through
unicorn_torch.convert.to_flax; the YOLOXDet tree is held against the JAX
model's own init tree (jax.eval_shape) and its round trip to the identity.

Tolerances, set before the first run at PR 2's fp32 and PR 1's bf16
bounds. fp32: atol 1e-4 on activations and logits (|max| up to ~10), 1e-5
on the resizes of unit-scale maps (one fused multiply-add order apart),
exact on the parameter layout; the NMS's valid rows and anchor indices
equal; masks (sigmoid scores) within 1e-4. bf16: the packed logits within
5% of their |max| for the largest difference and 1.5% for the mean of JAX
bf16's; masks of JAX's kept anchors within 0.05. The controllers and the
mask features are sums that cancel (a 3x3 conv of 1,152 products with
std-0.01 weights; seven 3x3 GroupNorm'd convs of 128 channels): bf16 moves
each framework's by up to 7.3% of |max| from fp32 (ROADMAP.md Queue 3), so
two bf16 runs are no test of the port. They are held against a JAX fp32
run of the same weights instead, at 8% / 1.5%: the port's measured 5.9%
largest difference plus a margin. The convex upsample with a bf16
up-mask: JAX rounds each step of its bf16 softmax, the port rounds the
softmax's output once, so 2^-7 relative of the output's |max|.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unicorn_torch.convert import from_flax, to_flax
from unicorn_torch.drivers.inst import make_inst_forward as t_inst
from unicorn_torch.models.unicorn import Unicorn as TUnicorn
from unicorn_torch.models.unicorn import YOLOXDet as TYOLOXDet
from unicorn_torch.ops import dynamic_conv as tdc
from unicorn_tpu.drivers.inst import make_inst_forward as j_inst
from unicorn_tpu.models import mask_head as jmh
from unicorn_tpu.models.unicorn import Unicorn as JUnicorn
from unicorn_tpu.models.unicorn import YOLOXDet as JYOLOXDet
from unicorn_tpu.ops import dynamic_conv as jdc

H = W = 64
DEPTH = 0.33
# tests/test_mask_stage.py:70-73
DET = dict(num_classes=5, backbone_name="csp_darknet", depth=DEPTH,
           width=0.25, in_channels=(256, 512, 1024), use_attention=False,
           n_layer_att=0, use_mask=True)
# tests/test_mask_stage.py:28-31, with the RAFT factor of the mask stage
UNI = dict(num_classes=1, backbone_name="csp_darknet", depth=DEPTH,
           width=0.25, in_channels=(256, 512, 1024), interact_mode="conv",
           n_layer_att=0, use_attention=False, use_mask=True, use_raft=True,
           up_rate=4)
INST = dict(conf_thre=0.0, nms_thre=0.65, max_out=16)


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


def _image(seed, h=H, w=W):
    return (np.random.RandomState(seed).rand(1, h, w, 3) * 255).astype(
        np.float32)


@pytest.fixture(scope="module")
def det():
    torch.set_num_threads(1)
    tm = TYOLOXDet(**DET, generator=torch.Generator().manual_seed(0)).eval()
    return tm, {"params": to_flax(tm.state_dict())}, \
        JYOLOXDet(**DET)


# ------------------------------------------------------------ dynamic_conv
def test_parse_dynamic_params_layout():
    """A known vector (0..168 per row, + 1000 * row): the reference layout,
    weights [80, 64, 8] then biases [8, 8, 1], each (out, in) row-major."""
    p = (np.arange(169)[None] + 1000 * np.arange(3)[:, None]).astype(
        np.float32)
    wt, bt = tdc.parse_dynamic_params(torch.from_numpy(p))
    wj, bj = jdc.parse_dynamic_params(jnp.asarray(p))
    assert [tuple(w.shape) for w in wt] == [(3, 10, 8), (3, 8, 8), (3, 8, 1)]
    assert [tuple(b.shape) for b in bt] == [(3, 8), (3, 8), (3, 1)]
    for a, b in zip(wt + bt, wj + bj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # weight (out 1, in 2) of layer 0 is entry 1 * 10 + 2; biases from 152
    assert wt[0][0, 2, 1] == 12 and bt[0][0, 0] == 152 and bt[2][2, 0] == 2168
    assert tdc.NUM_GEN_PARAMS == jdc.NUM_GEN_PARAMS == 169


@pytest.mark.parametrize("factor", [2, 4, 8])
def test_aligned_bilinear_matches_jax(factor):
    rng = np.random.RandomState(factor)
    x3 = rng.randn(3, 5, 7).astype(np.float32)
    x4 = rng.randn(2, 5, 7, 4).astype(np.float32)
    y3 = tdc.aligned_bilinear(torch.from_numpy(x3), factor)
    y4 = tdc.aligned_bilinear(_nchw(x4), factor)
    assert tuple(y3.shape) == (3, 5 * factor, 7 * factor)
    np.testing.assert_allclose(y3.numpy(), np.asarray(
        jdc.aligned_bilinear(jnp.asarray(x3), factor)), atol=1e-5)
    np.testing.assert_allclose(_nhwc(y4), np.asarray(
        jdc.aligned_bilinear(jnp.asarray(x4), factor)), atol=1e-5)


def test_resize_align_corners_matches_jax():
    x = np.random.RandomState(0).randn(2, 6, 9).astype(np.float32)
    for hw in ((11, 17), (3, 4), (6, 9)):
        np.testing.assert_allclose(
            tdc.resize_align_corners(torch.from_numpy(x), *hw).numpy(),
            np.asarray(jdc.resize_align_corners(jnp.asarray(x), *hw)),
            atol=1e-5)


@pytest.mark.parametrize("up_rate", [4, 8])
def test_convex_upsample_matches_jax(up_rate):
    rng = np.random.RandomState(up_rate)
    pred = rng.randn(3, 6, 5).astype(np.float32)
    m = (2 * rng.randn(6, 5, 9 * up_rate ** 2)).astype(np.float32)
    yt = tdc.convex_upsample(torch.from_numpy(pred),
                             torch.from_numpy(m.transpose(2, 0, 1)), up_rate)
    yj = jdc.convex_upsample(jnp.asarray(pred), jnp.asarray(m), up_rate)
    assert tuple(yt.shape) == (3, 6 * up_rate, 5 * up_rate)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5)
    # a bf16 up-mask: the softmax in bf16 on both sides
    mb = jnp.asarray(m, jnp.bfloat16)
    yj = np.asarray(jdc.convex_upsample(jnp.asarray(pred), mb, up_rate))
    yt = tdc.convex_upsample(
        torch.from_numpy(pred),
        torch.from_numpy(np.array(mb.astype(jnp.float32)).transpose(
            2, 0, 1)).bfloat16(), up_rate)
    assert yt.dtype == torch.float32
    assert np.abs(yt.numpy() - yj).max() <= 2 ** -7 * np.abs(yj).max()


def test_dynamic_mask_logits_matches_jax():
    rng = np.random.RandomState(0)
    feats = rng.randn(8, 12, 10).astype(np.float32)
    params = (0.3 * rng.randn(6, 169)).astype(np.float32)
    locs = rng.uniform(0, 96, (6, 2)).astype(np.float32)
    lvls = np.array([0, 1, 2, 0, 7, -1], np.int32)   # out of range: clipped
    yt = tdc.dynamic_mask_logits(torch.from_numpy(feats),
                                 torch.from_numpy(params),
                                 torch.from_numpy(locs),
                                 torch.from_numpy(lvls))
    yj = jdc.dynamic_mask_logits(jnp.asarray(feats.transpose(1, 2, 0)),
                                 jnp.asarray(params), jnp.asarray(locs),
                                 jnp.asarray(lvls))
    assert tuple(yt.shape) == (6, 12, 10)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-4)


def test_anchor_locations_and_levels_match_jax():
    from unicorn_torch.models.mask_head import anchor_locations_and_levels

    hw = [(8, 10), (4, 5), (2, 3)]
    lt, vt = anchor_locations_and_levels(hw, (8, 16, 32))
    lj, vj = jmh.anchor_locations_and_levels(hw, (8, 16, 32))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


# --------------------------------------------------------------- the models
@pytest.mark.parametrize("use_raft", [False, True])
def test_mask_branch_matches_flax(use_raft):
    """The branch on its own, on random FPN maps of the tiny model's widths
    (64, 128, 256 channels at strides 8, 16, 32 of 64x64)."""
    from unicorn_torch.models.blocks import init_weights
    from unicorn_torch.models.mask_head import MaskBranch

    mb = MaskBranch((64, 128, 256), use_raft=use_raft, up_rate=4).eval()
    init_weights(mb, torch.Generator().manual_seed(int(use_raft)))
    tree = to_flax({f"head.mask_branch.{k}": v
                    for k, v in mb.state_dict().items()})["mask_branch"]
    rng = np.random.RandomState(5)
    fpn = [rng.randn(2, H // s, W // s, c).astype(np.float32)
           for s, c in ((8, 64), (16, 128), (32, 256))]
    with torch.no_grad():
        out_t = mb([_nchw(f) for f in fpn])
    out_j = jmh.MaskBranch(use_raft=use_raft, up_rate=4).apply(
        {"params": tree}, [jnp.asarray(f) for f in fpn])
    assert tuple(out_t[0].shape) == (2, 8, H // 8, W // 8)
    assert (out_t[1] is None) == (not use_raft) == (out_j[1] is None)
    assert out_t[2] is None and out_j[2] is None
    for a, b in zip(out_t[:2], out_j[:2]):
        if a is not None:
            np.testing.assert_allclose(_nhwc(a), np.asarray(b), atol=1e-4)
    if use_raft:
        assert tuple(out_t[1].shape) == (2, 9 * 16, H // 8, W // 8)


def test_yolox_det_tree_round_trip_and_forward_match_jax(det):
    """The YOLOXDet tree (mask_branch at the top level, a head without the
    SOT predictions and priors, controllers): paths, shapes, round trip;
    then the head's raw outputs with ctrl, and the mask branch."""
    tm, params, jm = det
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, H, W, 3), jnp.float32))
    got = _leaves(params["params"])
    assert {k: v.shape for k, v in got.items()} == {
        k: v.shape for k, v in _leaves(shapes["params"]).items()}
    assert "head/controller2/Conv_0/kernel" in got
    assert not any("sot" in k or "beta" in k for k in got)
    state = from_flax(params)
    assert set(state) == set(tm.state_dict())
    for k, v in tm.state_dict().items():
        assert torch.equal(state[k], v), k
    img = _image(0)
    raw_j, mask_j = jax.jit(jm.apply)(params, jnp.asarray(img))
    with torch.no_grad():
        raw_t, mask_t = tm(_nchw(img))
    for lj, lt in zip(raw_j, raw_t):
        assert set(lj) == set(lt) and "ctrl" in lt
        assert lt["ctrl"].shape[1] == 169
        for key in lj:
            np.testing.assert_allclose(_nhwc(lt[key]), np.asarray(lj[key]),
                                       atol=1e-4, err_msg=key)
    assert mask_t[1] is None and mask_t[2] is None
    np.testing.assert_allclose(_nhwc(mask_t[0]), np.asarray(mask_j[0]),
                               atol=1e-4)


def test_make_inst_forward_matches_jax(det):
    """dets, valid and masks of the port's make_inst_forward against JAX's,
    conf_thre 0 so that the NMS keeps rows and every slot gets a mask."""
    tm, params, jm = det
    img = _image(1)
    dj, vj, mj = j_inst(jm, num_classes=5, **INST)(params, jnp.asarray(img))
    fwd = t_inst(tm, num_classes=5, device="cpu", **INST)
    dt_, vt, mt = fwd(_nchw(img))
    assert tuple(mt.shape) == (16, H // 4, W // 4)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert int(vt.sum()) > 1
    np.testing.assert_allclose(dt_.numpy(), np.asarray(dj), atol=1e-3,
                               rtol=1e-4)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), atol=1e-4)
    # the slots really differ: their masks come from their own controllers
    assert float((mt[0] - mt[1]).abs().max()) > 1e-3


def test_make_inst_forward_needs_a_card_unless_asked_for_the_cpu(det):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_inst(det[0], num_classes=5)


def test_unicorn_mask_branch_with_raft_matches_jax():
    """Unicorn(use_mask=True, use_raft=True, up_rate=4): the mask branch
    (features and the RAFT up-mask) and the RAFT mask decode of two
    controllers, from the model's own FPN maps."""
    tm = TUnicorn(**UNI, generator=torch.Generator().manual_seed(2)).eval()
    params = {"params": to_flax(tm.state_dict())}
    jm = JUnicorn(**UNI)
    img = _image(2)

    def fn(p, x):
        fpn, _ = jm.apply(p, x, method=JUnicorn.forward_backbone)
        return jm.apply(p, fpn, method=JUnicorn.forward_mask_branch)

    feats_j, up_j, sem_j = jax.jit(fn)(params, jnp.asarray(img))
    with torch.no_grad():
        fpn_t, _ = tm.forward_backbone(_nchw(img))
        feats_t, up_t, sem_t = tm.forward_mask_branch(fpn_t)
    assert sem_t is None and sem_j is None
    assert tuple(up_t.shape) == (1, 9 * 16, H // 8, W // 8)
    np.testing.assert_allclose(_nhwc(feats_t), np.asarray(feats_j), atol=1e-4)
    np.testing.assert_allclose(_nhwc(up_t), np.asarray(up_j), atol=1e-4)
    ctrl = (0.3 * np.random.RandomState(2).randn(2, 169)).astype(np.float32)
    locs = np.array([[20.0, 12.0], [40.0, 52.0]], np.float32)
    lvls = np.array([0, 1], np.int32)
    lj = jdc.dynamic_mask_logits(feats_j[0], jnp.asarray(ctrl),
                                 jnp.asarray(locs), jnp.asarray(lvls))
    mj = jdc.convex_upsample(lj, up_j[0], 4)
    lt = tdc.dynamic_mask_logits(feats_t[0], torch.from_numpy(ctrl),
                                 torch.from_numpy(locs),
                                 torch.from_numpy(lvls))
    mt = tdc.convex_upsample(lt, up_t[0], 4)
    assert tuple(mt.shape) == (2, H // 2, W // 2)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), atol=1e-4)


def test_inst_bf16_convnext_matches_jax():
    """One bf16 case: ConvNeXt-Tiny width 0.5 with one head attention block
    a level, 96x160: the packed logits against JAX bf16, the controllers
    and the mask features against JAX fp32, and the masks of JAX's kept
    anchors (with conf_thre 0, bf16 noise
    reorders near-tied scores, so the two NMSs keep other anchors)."""
    cfg = dict(num_classes=3, backbone_name="convnext_tiny", width=0.5,
               use_attention=True, n_layer_att=1, use_mask=True)
    tm = TYOLOXDet(**cfg, dtype=torch.bfloat16,
                   generator=torch.Generator().manual_seed(3)).eval()
    params = {"params": to_flax(tm.state_dict())}
    jm = JYOLOXDet(**cfg, dtype=jnp.bfloat16)
    img = _image(3, 96, 160)
    (raw_j, mask_j), (_, _, mj), idx_j = _jax_inst_with_idx(jm, params,
                                                            img)
    fwd = t_inst(tm, num_classes=3, device="cpu", **INST)
    raw_t, mask_t = fwd.forward(_nchw(img))
    flat = fwd.detect(raw_t)[0]
    masks_t = fwd.masks(flat, torch.from_numpy(np.array(idx_j))[None],
                        mask_t)
    # controllers and mask features: against JAX in fp32, same weights
    raw_f, mask_f = jax.jit(JYOLOXDet(**cfg).apply)(params, jnp.asarray(img))
    pairs = [(lt[k], lj[k], 0.05, 0.015) for lt, lj in zip(raw_t, raw_j)
             for k in ("_cls_packed", "_reg_packed")]
    pairs += [(lt["ctrl"], lf["ctrl"], 0.08, 0.015)
              for lt, lf in zip(raw_t, raw_f)]
    pairs.append((mask_t[0], mask_f[0], 0.08, 0.015))
    for a, b, tol_max, tol_mean in pairs:
        assert a.dtype == torch.bfloat16
        ref = np.asarray(b).astype(np.float32)
        d = np.abs(_nhwc(a) - ref)
        scale = np.abs(ref).max()
        assert d.max() <= tol_max * scale and d.mean() <= tol_mean * scale
    assert masks_t.dtype == torch.float32
    assert tuple(masks_t.shape) == (16, 96 // 4, 160 // 4)
    np.testing.assert_allclose(masks_t.numpy(), np.asarray(mj), atol=0.05)


def _jax_inst_with_idx(jm, params, img):
    """JAX's raw outputs, make_inst_forward's (dets, valid, masks), and the
    kept anchor indices of its NMS."""
    from unicorn_tpu.models.heads import decode_boxes, flatten_raw_outputs
    from unicorn_tpu.ops.nms import postprocess_device

    x = jnp.asarray(img)
    raw, mask_out = jax.jit(jm.apply)(params, x)
    flat = flatten_raw_outputs(raw, "mot")
    boxes = decode_boxes(flat["reg_raw"], flat["hw"], (8, 16, 32))
    dec = jnp.concatenate([boxes, jax.nn.sigmoid(flat["obj_logits"]),
                           jax.nn.sigmoid(flat["cls_logits"])], -1)
    _, _, idx = postprocess_device(dec, num_classes=3, n_cand=512,
                                   return_idx=True, **INST)
    out = j_inst(jm, num_classes=3, **INST)(params, x)
    return (raw, mask_out), out, idx[0]


def test_exp_classes_build_the_mask_models():
    from unicorn_torch.exp.unicorn_inst_convnext_tiny_800x1280 import \
        Exp as InstExp
    from unicorn_torch.exp.unicorn_track_tiny_mask import Exp as TrackMaskExp

    exp = InstExp()
    assert (exp.num_classes, exp.test_size, exp.d_rate) == (80, (800, 1280),
                                                            4)
    exp.width = 0.5                       # a narrow PAFPN and head: fast
    model = exp.get_model()
    assert isinstance(model, TYOLOXDet) and model.dtype == torch.bfloat16
    assert len(model.head.controllers) == 3
    assert model.head.mask_branch.up_mask_layer is None
    assert len(model.head.att_layers[0]) == 3
    fwd = exp.get_inst_forward(model, device="cpu")
    assert (fwd.use_raft, fwd.up_rate, fwd.conf_thre) == (False, 2, 0.01)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            exp.get_inst_forward(model)

    tex = TrackMaskExp()
    assert (tex.use_raft, tex.up_rate, tex.interact_mode) == (True, 4,
                                                              "deform")
    tex.width = 0.5
    uni = tex.get_model(serve=True)
    assert uni.head.mask_branch.up_mask_layer[2].out_channels == 9 * 16
    assert uni.interact_dtype == torch.bfloat16
    # the mask stage's training factories: AdamW with accumulation, only
    # the controllers and the mask branch train
    tx = tex.get_optimizer(2)
    assert (tx.kind, tx.grad_accum) == ("adamw", 2)
    trains = tx.trainable_mask_fn(uni.named_parameters())
    assert trains["head.controllers.0.weight"]
    assert trains["head.mask_branch.up_mask_layer.2.weight"]
    assert not trains["upsample_layer.1.weight"]
    assert callable(tex.get_train_step(2))
