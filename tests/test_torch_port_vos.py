"""The port's VOS driver (unicorn_torch.drivers.vos.VOSDriver) against the
JAX package's, on the CPU.

Models: the JAX VOS tests' tiny model (tests/test_drivers.py:14-22,
use_mask=True: CSPDarknet depth 0.33 width 0.25, "conv" interaction, no
head attention, 64x64) with the RAFT up-mask at rate 4, and one case on
ConvNeXt-Tiny width 0.5 at 96x160 with the deformable interaction (one head
attention block a level) and the same mask fields, whose general path runs
MSDA's plain version at batch K. Parameters come from the port's seeded
init and reach JAX through unicorn_torch.convert.to_flax.

Cases: `initialize` (reference feature, label maps, ids, valid slots) at
r = 1; the shared-reference path against JAX `_track_fn_shared`; the
general path after `add_objects` against JAX `_track_fn`; the shared
path equal to the general path (as tests/test_drivers.py:178 checks them
in JAX); `aggregate` against
`aggregate_fn`; `postprocess_masks_host` at r != 1 (48x56 frames into
64x64) against JAX's cv2 tail; the mid-video entry, two objects entering on
one frame, both overflow errors; the card requirement.

Tolerances, set before the first run at the SOT driver tests' bounds
(tests/test_torch_port_sot.py). fp32: boxes within 1e-2 px, scores (obj,
cls) and mask probabilities within 1e-4, class ids and `valid` equal; the
reference feature within 1e-4 and the label maps within 1e-6. Port path
against port path: rtol 2e-4, atol 2e-3 (tests/test_drivers.py:178's).
`aggregate`: equal labels.
The tail: the port resizes with F.interpolate (half-pixel bilinear), JAX
with cv2.resize INTER_LINEAR on float32; the label maps must be equal at
every pixel where JAX's top two of (bg, p_1 .. p_K) differ by more than
1e-3, and that margin may exclude at most 1% of the pixels; the boxes and
the entry overlay are equal.
"""
import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unicorn_torch.convert import to_flax
from unicorn_torch.drivers.vos import VOSDriver as TVOSDriver
from unicorn_torch.models.unicorn import Unicorn as TUnicorn
from unicorn_tpu.drivers.vos import VOSDriver as JVOSDriver
from unicorn_tpu.models.unicorn import Unicorn as JUnicorn

H = W = 64
# tests/test_drivers.py:14-17 with use_mask, and the RAFT factor of
# tests/test_torch_port_mask.py's UNI
UNI = dict(num_classes=1, backbone_name="csp_darknet", depth=0.33,
           width=0.25, in_channels=(256, 512, 1024), interact_mode="conv",
           n_layer_att=0, use_attention=False, use_mask=True, use_raft=True,
           up_rate=4)
# tests/test_torch_port_sot.py:35-36, one head attention block a level
DEFORM = dict(num_classes=8, backbone_name="convnext_tiny", width=0.5,
              n_layer_att=1, use_mask=True, use_raft=True, up_rate=4)
DRV = dict(conf_thre=0.0, use_raft=True, up_rate=4)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _frame(rng, h=H, w=W):
    return (rng.rand(h, w, 3) * 255).astype(np.uint8)


def _mask(h, w, rects):
    m = np.zeros((h, w), np.uint8)
    for oid, (y0, y1, x0, x1) in rects.items():
        m[y0:y1, x0:x1] = oid
    return m


def _nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


def _drivers(cfg, seed, input_size, K):
    tm = TUnicorn(**cfg, generator=torch.Generator().manual_seed(seed))
    params = {"params": to_flax(tm.eval().state_dict())}
    dj = JVOSDriver(JUnicorn(**cfg), params, input_size=input_size,
                    max_objects=K, **DRV)
    dt_ = TVOSDriver(tm, input_size=input_size, max_objects=K,
                     device="cpu", **DRV)
    return dj, dt_


def _np(outs):
    return tuple(None if o is None else np.asarray(o) for o in outs)


def _j_outs(fn, dj, ref, frame):
    return _np(fn(dj.params, ref, dj.lbs_ref, frame))


@pytest.fixture(scope="module")
def tiny():
    """Both drivers on the tiny model: initialize with two objects, the
    shared path, then object 7 enters and the general paths run."""
    torch.set_num_threads(1)
    dj, dt_ = _drivers(UNI, 0, (H, W), 3)
    rng = np.random.RandomState(1)
    f0, f1, f2, f3 = (_frame(rng) for _ in range(4))
    m0 = _mask(H, W, {1: (5, 20, 5, 20), 2: (25, 40, 30, 50)})
    out = {"dj": dj, "dt": dt_}
    for d in (dj, dt_):
        d.initialize(f0, m0)
    out["init"] = dict(feat_ref=_nhwc(dt_.feat_ref), feat_j=np.asarray(
        dj.feat_ref), lbs=dt_.lbs_ref.numpy(), lbs_j=np.asarray(dj.lbs_ref),
        ids=(list(dt_.obj_ids), list(dj.obj_ids)),
        valid=(dt_.obj_valid.copy(), dj.obj_valid.copy()),
        shared=(dt_.shared_ref, dj.shared_ref))
    img, _ = dt_.preprocess(f1)
    frame, _ = dj._preproc(f1)
    out["shared"] = (_np(dt_.track_fn_shared(img)),
                     _j_outs(dj._track_fn_shared, dj, dj.feat_ref1, frame))
    out["same_frame"] = (out["shared"][0], _np(dt_.track_fn(img)))
    m2 = _mask(H, W, {7: (30, 44, 2, 18)})
    for d in (dj, dt_):
        d.add_objects(f2, m2)
    out["entry"] = dict(ids=(list(dt_.obj_ids), list(dj.obj_ids)),
                        lbs=dt_.lbs_ref.numpy(), lbs_j=np.asarray(dj.lbs_ref),
                        shared=(dt_.shared_ref, dj.shared_ref))
    img, _ = dt_.preprocess(f3)
    frame, _ = dj._preproc(f3)
    out["general"] = (_np(dt_.track_fn(img)),
                      _j_outs(dj._track_fn, dj, dj.feat_ref, frame))
    return out


def _assert_outs_match_jax(outs_t, outs_j, n_valid_min=1):
    (dt_, vt, mt), (dj, vj, mj) = outs_t, outs_j
    assert dt_.shape == dj.shape and mt.shape == mj.shape
    np.testing.assert_array_equal(vt, vj)
    assert vt.sum() >= n_valid_min
    np.testing.assert_allclose(dt_[..., :4], dj[..., :4], atol=1e-2)
    np.testing.assert_allclose(dt_[..., 4:6], dj[..., 4:6], atol=1e-4)
    np.testing.assert_array_equal(dt_[..., 6], dj[..., 6])
    np.testing.assert_allclose(mt, mj, atol=1e-4)


def _assert_paths_equal(a, b):
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_allclose(a[0], b[0], rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(a[2], b[2], rtol=2e-4, atol=2e-3)


def test_initialize_matches_jax(tiny):
    init = tiny["init"]
    assert init["ids"] == ([1, 2], [1, 2])
    np.testing.assert_array_equal(*init["valid"])
    assert init["shared"] == (True, True)
    assert init["feat_ref"].shape == init["feat_j"].shape == (3, 4, 4, 128)
    np.testing.assert_allclose(init["feat_ref"], init["feat_j"], atol=1e-4)
    assert init["lbs"].shape == (3, 1, (H // 8) * (W // 8))
    np.testing.assert_allclose(init["lbs"], init["lbs_j"], atol=1e-6)
    assert init["lbs"][:2].sum(-1).min() > 0 and init["lbs"][2].sum() == 0


def test_shared_path_matches_jax(tiny):
    t, j = tiny["shared"]
    assert t[2].shape == (3, H, W)
    _assert_outs_match_jax(t, j)
    # the slots really differ: each has its own prior and controllers
    assert np.abs(t[2][0] - t[2][1]).max() > 1e-3


def test_general_path_after_entry_matches_jax(tiny):
    ids, entry = tiny["entry"]["ids"], tiny["entry"]
    assert ids == ([1, 2, 7], [1, 2, 7])
    assert entry["shared"] == (False, False)
    np.testing.assert_allclose(entry["lbs"], entry["lbs_j"], atol=1e-6)
    _assert_outs_match_jax(*tiny["general"])


def test_shared_path_equals_the_general_path(tiny):
    _assert_paths_equal(*tiny["same_frame"])


def test_aggregate_matches_jax(tiny):
    dt_, dj = tiny["dt"], tiny["dj"]
    rng = np.random.RandomState(3)
    probs = [tiny["general"][0][2], rng.rand(3, H, W).astype(np.float32)]
    for p in probs:
        for valid in (np.ones(3, np.float32),
                      np.array([1, 0, 1], np.float32)):
            lt = dt_.aggregate(torch.from_numpy(p), valid).numpy()
            lj = np.asarray(dj._aggregate(jnp.asarray(p), jnp.asarray(valid)))
            np.testing.assert_array_equal(lt, lj)
            assert valid[1] or not (lt == 2).any()


def _tail_inputs():
    """Four slots: 1 and 2 detected, 5 without a detection, 7 on its entry
    frame; smooth overlapping probability blobs at the input size."""
    rng = np.random.RandomState(4)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    centres = [(20, 18), (30, 34), (44, 20), (40, 48)]
    masks = np.stack([np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 150.0)
                      for cy, cx in centres]).astype(np.float32)
    dets = (rng.rand(4, 8, 7) * 60).astype(np.float32)
    valid = np.zeros((4, 8), bool)
    valid[0, :3] = valid[1, :1] = valid[3, :2] = True
    gt7 = np.zeros((48, 56), bool)
    gt7[30:40, 40:50] = True
    return dets, valid, masks, gt7


def _cv2_probs(masks, agg_valid, r, orig):
    """JAX's tail up to the argmax (drivers/vos.py:375-400), to find the
    pixels whose top two scores nearly tie."""
    h, w = orig
    Hn, Wn = int(round(H / r)), int(round(W / r))
    probs = np.zeros((len(masks), h, w), np.float32)
    for k, m in enumerate(masks.astype(np.float16).astype(np.float32)):
        if agg_valid[k] > 0:
            probs[k] = cv2.resize(m * agg_valid[k], (Wn, Hn),
                                  interpolation=cv2.INTER_LINEAR)[:h, :w]
    return np.concatenate([np.prod(1.0 - probs, 0, keepdims=True), probs])


def test_postprocess_masks_host_matches_jax_tail(tiny):
    dets, valid, masks, gt7 = _tail_inputs()
    jm, tm = tiny["dj"].model, tiny["dt"].model
    dj = JVOSDriver(jm, tiny["dj"].params, input_size=(H, W),
                    max_objects=4, **DRV)
    dt_ = TVOSDriver(tm, input_size=(H, W), max_objects=4, device="cpu",
                     **DRV)
    r = min(H / 48, W / 56)
    for d in (dj, dt_):
        d.obj_ids = [1, 2, 5, 7]
        d.obj_valid = np.ones(4, np.float32)
        d.orig_shape = (48, 56)
        d._entry_overlay = {7: gt7}
    out_j, boxes_j = dj.postprocess_masks_host(
        jnp.asarray(dets), jnp.asarray(valid), jnp.asarray(masks), r)
    out_t, boxes_t = dt_.postprocess_masks_host(
        torch.from_numpy(dets), torch.from_numpy(valid),
        torch.from_numpy(masks), r)
    assert out_t.dtype == np.uint8 and out_t.shape == (48, 56)
    assert boxes_t == boxes_j and set(boxes_t) == {1, 2, 7}
    assert dt_._entry_overlay == {} and dj._entry_overlay == {}
    assert (out_t[gt7] == 7).all() and set(np.unique(out_t)) == {0, 1, 2, 7}
    scores = np.sort(_cv2_probs(masks, np.array([1, 1, 0, 0], np.float32),
                                r, (48, 56)), 0)
    clear = (scores[-1] - scores[-2]) > 1e-3
    assert clear.mean() >= 0.99
    np.testing.assert_array_equal(out_t[clear], out_j[clear])
    # no masks (a model without the mask branch): boxes only
    dt_._entry_overlay = {7: gt7}
    none_t = dt_.postprocess_masks_host(torch.from_numpy(dets),
                                        torch.from_numpy(valid), None, r)
    assert none_t == (None, boxes_j) and dt_._entry_overlay == {}


def test_track_mid_video_entry_and_slots(tiny):
    """tests/test_drivers.py:56 and :86 on the port: an object entering at
    frame 2 gets a slot and its GT mask on the entry frame; two objects
    entering on one frame get distinct slots; overflow raises."""
    dt_ = TVOSDriver(tiny["dt"].model, input_size=(H, W), max_objects=4,
                     device="cpu", **DRV)
    rng = np.random.RandomState(5)
    imgs = [_frame(rng, 48, 56) for _ in range(5)]
    dt_.initialize(imgs[0], _mask(48, 56, {1: (5, 20, 5, 20)}))
    out1, _ = dt_.track(imgs[1])
    assert out1.shape == (48, 56) and set(np.unique(out1)) <= {0, 1}
    m2 = _mask(48, 56, {5: (2, 14, 30, 54), 6: (30, 44, 2, 18)})
    dt_.add_objects(imgs[2], m2)
    assert dt_.obj_ids == [1, 5, 6] and dt_.obj_valid[:3].sum() == 3
    assert not dt_.shared_ref
    lb5, lb6 = dt_.lbs_ref[1].numpy(), dt_.lbs_ref[2].numpy()
    assert lb5.sum() > 0 and lb6.sum() > 0 and not np.allclose(lb5, lb6)
    dt_.add_objects(imgs[2], m2)            # known ids: a no-op
    assert dt_.obj_ids == [1, 5, 6]
    out2, _ = dt_.track(imgs[2])            # the entry frame: GT verbatim
    assert (out2[m2 == 5] == 5).all() and (out2[m2 == 6] == 6).all()
    out3, _ = dt_.track(imgs[3])
    assert set(np.unique(out3)) <= {0, 1, 5, 6}
    with pytest.raises(ValueError, match="slots"):
        dt_.add_objects(imgs[4], _mask(48, 56, {8: (10, 20, 40, 50),
                                                9: (30, 40, 40, 50)}))
    d1 = TVOSDriver(tiny["dt"].model, input_size=(H, W), max_objects=1,
                    device="cpu", **DRV)
    with pytest.raises(ValueError, match="max_objects"):
        d1.initialize(imgs[0], m2)


def test_vos_driver_needs_a_card_unless_asked_for_the_cpu(tiny):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TVOSDriver(tiny["dt"].model, input_size=(H, W))


def test_general_path_on_the_deform_model_matches_jax():
    """ConvNeXt-Tiny width 0.5 at 96x160, deformable interaction: after a
    mid-video entry the interaction runs at batch 3 (MSDA's plain version
    at batch K) and the correlation at batch 3 with one map each."""
    h, w = 96, 160
    dj, dt_ = _drivers(DEFORM, 1, (h, w), 3)
    rng = np.random.RandomState(6)
    f0, f1, f2 = (_frame(rng, h, w) for _ in range(3))
    for d in (dj, dt_):
        d.initialize(f0, _mask(h, w, {1: (10, 40, 20, 60),
                                      2: (40, 80, 90, 140)}))
        d.add_objects(f1, _mask(h, w, {4: (50, 90, 10, 50)}))
    assert dt_.feat_ref.shape[0] == 3 and not dt_.shared_ref
    np.testing.assert_allclose(_nhwc(dt_.feat_ref), np.asarray(dj.feat_ref),
                               atol=1e-4)
    img, _ = dt_.preprocess(f2)
    frame, _ = dj._preproc(f2)
    outs_t = _np(dt_.track_fn(img))
    _assert_outs_match_jax(outs_t, _j_outs(dj._track_fn, dj, dj.feat_ref,
                                           frame))
    assert outs_t[2].shape == (3, h, w)
