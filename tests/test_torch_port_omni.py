"""The port's omni MOT driver (unicorn_torch.drivers.mot.MOTOmniDriver:
QDTrack or DeepSORT association on the model's instance embeddings, with
and without a CondInst mask per track) against the JAX package's, on the
CPU.

Models: the JAX driver tests' tiny model (tests/test_drivers.py:14-22:
CSPDarknet depth 0.33 width 0.25, "conv" interaction, no head attention,
64x64) with the mask branch and its RAFT up-mask at rate 4
(tests/test_torch_port_vos.py's), and one ConvNeXt-Tiny width 0.5 case at
96x160 with the deformable interaction, whose omni path runs MSDA's plain
version once a frame. Parameters come from the port's seeded init, with
the obj/cls prediction biases raised by 6 so that the NMS keeps rows over
the tracker's thresholds, and reach JAX through
unicorn_torch.convert.to_flax. Frames are at the input size (a panning
texture), where the two letterboxes are equal (ROADMAP.md Queue 3).

Cases, 4 frames each: QDTrack and DeepSORT without masks; QDTrack and
DeepSORT with masks (aligned_bilinear, JAX's default); QDTrack with masks
through the RAFT up-mask (use_raft); after the DeepSORT mask run, a frame
at conf_thre 1.0 (no detection passes: the confirmed tracks coast with
zero masks on the mask grid) and the QDTrack empty frame; `reset`; the
deform model; invalid rows (zero boxes, anchor 0) kept away from the
tracker and the masks; `device="cuda"` without a card.

Tolerances, stated before the first run (the VOS and SOT driver tests'
fp32 bounds): boxes within 1e-2 px; scores, embeddings (the packed
dets | valid | embeds fetch) and mask probabilities within 1e-4; ids,
labels, valid rows, classes and the number of rows equal. The
embeddings' bound is 1e-4 of their scale, max(1, |max|): on the deform
model (|max| 2.1-2.3 after a ConvNeXt trunk, the deformable interaction
and the upsample) the first run met 1.1e-4-1.4e-4 absolute, 4.6e-5-6.1e-5
of |max|, at 0-6 of 16,384 values a frame (mean 5.6e-6). Both drivers
store the mask probabilities as float16 (JAX's contract), so two values
within 1e-4 may round one float16 ulp apart: the fetched masks are held
within 1e-4 plus one float16 ulp of JAX's value (at most 2^-11, which the
first run met at 0.13% of the values).
"""
import copy

import numpy as np
import pytest
import torch

from unicorn_torch.convert import to_flax
from unicorn_torch.drivers.mot import MOTOmniDriver as TOmni
from unicorn_torch.models import interaction
from unicorn_torch.models.unicorn import Unicorn as TUnicorn
from unicorn_tpu.drivers.mot import MOTOmniDriver as JOmni
from unicorn_tpu.models.unicorn import Unicorn as JUnicorn

H = W = 64
# tests/test_drivers.py:14-17 with the mask branch and the RAFT factor of
# tests/test_torch_port_vos.py's UNI
UNI = dict(num_classes=1, backbone_name="csp_darknet", depth=0.33,
           width=0.25, in_channels=(256, 512, 1024), interact_mode="conv",
           n_layer_att=0, use_attention=False, use_mask=True, use_raft=True,
           up_rate=4)
# tests/test_torch_port_vos.py's DEFORM: one head attention block a level
DEFORM = dict(num_classes=8, backbone_name="convnext_tiny", width=0.5,
              n_layer_att=1, use_mask=True, use_raft=True, up_rate=4)
QD = dict(init_score_thr=0.75, obj_score_thr=0.7)
DRV = dict(conf_thre=0.6, up_rate=4, qd_params=QD)
N_FRAMES = 4
# case -> (JAX driver key: with_mask, use_raft; tracker)
CASES = {"qd": ((False, False), "qd"),
         "deepsort": ((False, False), "deepsort"),
         "qd_mask": ((True, False), "qd"),
         "deepsort_mask": ((True, False), "deepsort"),
         "qd_mask_raft": ((True, True), "qd")}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _frames(n, h=H, w=W, seed=1):
    rng = np.random.RandomState(seed)
    base = (rng.rand(h, w + 3 * n, 3) * 255).astype(np.uint8)
    return [np.ascontiguousarray(base[:, 3 * t:3 * t + w]) for t in range(n)]


def _models(cfg, seed):
    tm = TUnicorn(**cfg, generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for name, p in tm.head.named_parameters():
            if name.startswith(("obj_preds", "cls_preds")) and \
                    name.endswith(".bias"):
                p.add_(6.0)
    return tm.eval(), JUnicorn(**cfg), {"params": to_flax(tm.state_dict())}


def _spy(driver_t, driver_j):
    """Record each frame's packed fetch on both sides, and on the port the
    rows the tracker received and the mask rows it fetched."""
    rec = dict(packed_t=[], packed_j=[], tracker_rows=[], mask_rows=[])
    fetch, step = driver_t.fetch, driver_j._step
    fetch_masks, associate = driver_t.fetch_masks, driver_t.associate

    def spy_fetch(*a):
        rec["packed_t"].append(fetch(*a))
        return rec["packed_t"][-1]

    def spy_step(*a):
        out = step(*a)
        rec["packed_j"].append(np.asarray(out[0]))
        return out

    def spy_associate(packed, r):
        tracker = driver_t.tracker
        inner = tracker.update if driver_t.tracker_kind == "deepsort" \
            else tracker.match
        name = inner.__name__

        def count(*a, **k):
            rec["tracker_rows"].append(len(a[0]))
            return inner(*a, **k)

        setattr(tracker, name, count)
        try:
            return associate(packed, r)
        finally:
            delattr(tracker, name)

    def spy_fetch_masks(masks, rows):
        rec["mask_rows"].append(rows)
        return fetch_masks(masks, rows)

    driver_t.fetch, driver_j._step = spy_fetch, spy_step
    driver_t.associate, driver_t.fetch_masks = spy_associate, spy_fetch_masks
    return rec


@pytest.fixture(scope="module")
def tiny():
    """Every case of CASES on both drivers; one JAX driver (one compiled
    step) per (with_mask, use_raft), its tracker swapped between cases."""
    torch.set_num_threads(1)
    tm, jm, params = _models(UNI, 0)
    frames = _frames(N_FRAMES + 2)
    jax_drivers, out = {}, {}
    for case, ((with_mask, use_raft), kind) in CASES.items():
        kw = dict(input_size=(H, W), with_mask=with_mask, use_raft=use_raft,
                  **DRV)
        if (with_mask, use_raft) not in jax_drivers:
            dj = JOmni(jm, params, **kw)
            jax_drivers[with_mask, use_raft] = (dj, dj._step)
        dj, step = jax_drivers[with_mask, use_raft]
        dj._step = step             # the last case's spy off
        dj.tracker_kind = kind
        dj.reset()
        dt_ = TOmni(tm, tracker=kind, device="cpu", **kw)
        rec = _spy(dt_, dj)
        rec["outs"] = [(dt_.update(f), dj.update(f))
                       for f in frames[:N_FRAMES]]
        rec["drivers"] = (dt_, dj)
        out[case] = rec
    out["model"] = (tm, jm, params)
    out["frames"] = frames
    return out


def _assert_packed_match(pt, pj):
    assert pt.shape == pj.shape
    np.testing.assert_array_equal(pt[:, 7], pj[:, 7])      # valid
    np.testing.assert_array_equal(pt[:, 6], pj[:, 6])      # class
    np.testing.assert_allclose(pt[:, :4], pj[:, :4], atol=1e-2)
    np.testing.assert_allclose(pt[:, 4:6], pj[:, 4:6], atol=1e-4)
    scale = max(1.0, float(np.abs(pj[:, 8:]).max()))
    np.testing.assert_allclose(pt[:, 8:], pj[:, 8:], atol=1e-4 * scale)


def _assert_outs_match(ot, oj):
    assert len(ot) == len(oj)
    (bt, lt, it), (bj, lj, ij) = ot[:3], oj[:3]
    assert bt.shape == bj.shape and bt.shape[1:] == (5,)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(lt, lj)
    np.testing.assert_allclose(bt[:, :4], bj[:, :4], atol=1e-2)
    np.testing.assert_allclose(bt[:, 4], bj[:, 4], atol=1e-4)
    if len(ot) == 4:
        assert ot[3].shape == oj[3].shape and ot[3].dtype == np.float32
        # float16 values: 1e-4 before the store, plus the one float16 ulp
        # that two roundings of values 1e-4 apart may add
        ulp = np.spacing(oj[3].astype(np.float16)).astype(np.float32)
        assert (np.abs(ot[3] - oj[3]) <= 1e-4 + ulp).all()


@pytest.mark.parametrize("case", list(CASES))
def test_omni_driver_matches_jax(tiny, case):
    rec = tiny[case]
    (with_mask, _), _ = CASES[case]
    assert len(rec["packed_t"]) == len(rec["packed_j"]) == N_FRAMES
    for pt, pj in zip(rec["packed_t"], rec["packed_j"]):
        _assert_packed_match(pt, pj)
    n_rows = 0
    for ot, oj in rec["outs"]:
        assert len(ot) == (4 if with_mask else 3)
        _assert_outs_match(ot, oj)
        n_rows += len(ot[0])
        if with_mask and len(ot[0]):
            # stride 4, or stride 8 / up_rate through the RAFT up-mask
            grid = (H // 2, W // 2) if case.endswith("raft") else \
                (H // 4, W // 4)
            assert ot[3].shape[1:] == grid
            assert 0.0 <= ot[3].min() and ot[3].max() <= 1.0
    # the run tracked something: rows out, and ids carried across frames
    assert n_rows > 0
    ids = [set(o[0][2].tolist()) for o in rec["outs"]]
    assert any(a & b for a, b in zip(ids, ids[1:]))


def test_invalid_rows_reach_neither_tracker_nor_masks(tiny):
    """Invalid rows have zero boxes (sampled at (0, 0)) and anchor 0 (mask
    decoded from anchor 0's controllers): none reaches the tracker or the
    fetched masks. QDTrack's mask rows are the detections of its output
    rows (return_index composed with the valid slots)."""
    for case in ("qd_mask", "deepsort_mask"):
        rec = tiny[case]
        for packed, n_in, rows, (ot, _) in zip(
                rec["packed_t"], rec["tracker_rows"], rec["mask_rows"],
                rec["outs"]):
            valid = np.flatnonzero(packed[:, 7] > 0.5)
            assert 0 < len(valid) < len(packed)     # both kinds of row
            assert n_in == len(valid)
            assert len(rows) == len(ot[0])
            assert set(rows[rows >= 0].tolist()) <= set(valid.tolist())
            if case == "qd_mask":                   # frames at r = 1
                np.testing.assert_array_equal(packed[rows, :4], ot[0][:, :4])


def test_empty_frame_and_coasting_masks_match_jax(tiny):
    """conf_thre 1.0: no detection passes. DeepSORT (carrying the
    mask run's tracker) steps its table and returns its confirmed tracks
    as coasting rows with zero masks on the mask grid; QDTrack returns the
    empty shapes, masks (0, H/4, W/4)."""
    tm, jm, params = tiny["model"]
    dt0, dj0 = tiny["deepsort_mask"]["drivers"]
    kw = dict(DRV, conf_thre=1.0)
    dj = JOmni(jm, params, input_size=(H, W), with_mask=True,
               tracker="deepsort", **kw)
    dt_ = TOmni(tm, input_size=(H, W), with_mask=True, tracker="deepsort",
                device="cpu", **kw)
    for new, old in ((dt_, dt0), (dj, dj0)):
        new.tracker = copy.deepcopy(old.tracker)
        new.feat_prev, new.frame_id = old.feat_prev, old.frame_id
    f = tiny["frames"][N_FRAMES]
    ot, oj = dt_.update(f), dj.update(f)
    _assert_outs_match(ot, oj)
    assert len(ot[0]) > 0, "no confirmed track to coast"
    assert dt_.tracker.last_det_indices == [-1] * len(ot[0])
    assert ot[3].shape == (len(ot[0]), H // 4, W // 4)
    assert not ot[3].any()
    for d in (dt_, dj):
        d.tracker_kind = "qd"
        d.reset()
    ot, oj = dt_.update(f), dj.update(f)
    _assert_outs_match(ot, oj)
    assert [o.shape for o in ot] == [(0, 5), (0,), (0,), (0, H // 4, W // 4)]


def test_reset_matches_jax(tiny):
    dt_, dj = tiny["qd"]["drivers"]
    dj.tracker_kind = "qd"      # the deepsort case took this JAX driver on
    for d in (dt_, dj):
        d.reset()
        assert d.frame_id == 0 and d.feat_prev is None
    assert dt_.input_size == dj.input_size == (H, W)
    f = tiny["frames"][N_FRAMES + 1]
    ot, oj = dt_.update(f), dj.update(f)
    _assert_outs_match(ot, oj)
    assert len(ot[2]) and ot[2].min() == 0      # ids start again at 0
    assert dt_.frame_id == 1 and dt_.feat_prev is not None
    assert dt_.last_scale == dj.last_scale == 1.0


def test_deform_model_through_msda_matches_jax(monkeypatch):
    """ConvNeXt-Tiny width 0.5 at 96x160, deformable interaction: each frame
    interacts with the previous one (the first with itself) through MSDA's
    plain version, once a frame; QDTrack with masks."""
    h, w = 96, 160
    tm, jm, params = _models(DEFORM, 1)
    kw = dict(input_size=(h, w), num_classes=8, with_mask=True, **DRV)
    dj = JOmni(jm, params, **kw)
    dt_ = TOmni(tm, device="cpu", **kw)
    rec = _spy(dt_, dj)
    calls = []
    msda = interaction.ms_deform_attn

    def counting(*a, **k):
        calls.append(a[0].dtype)
        return msda(*a, **k)

    monkeypatch.setattr(interaction, "ms_deform_attn", counting)
    n_rows = 0
    for f in _frames(3, h, w, seed=2):
        ot, oj = dt_.update(f), dj.update(f)
        _assert_outs_match(ot, oj)
        n_rows += len(ot[0])
    for pt, pj in zip(rec["packed_t"], rec["packed_j"]):
        _assert_packed_match(pt, pj)
    assert calls == [torch.float32] * 3
    assert n_rows > 0


def test_omni_driver_needs_a_card_unless_asked_for_the_cpu(tiny):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TOmni(tiny["model"][0], input_size=(H, W))
    with pytest.raises(ValueError, match="tracker"):
        TOmni(tiny["model"][0], input_size=(H, W), tracker="sort",
              device="cpu")


def test_served_model_runs_msda_once_a_frame_in_bf16(monkeypatch):
    """ExpTrack.get_model(serve=True) (unicorn_track_tiny at full width, on
    a 96x160 input): the driver hands the interaction fp32 features, as
    JAX does, and MSDA runs once a frame in bf16 (serve_interact_bf16,
    tools/track_omni.py:55-56)."""
    from unicorn_torch.exp.unicorn_track_tiny import Exp

    exp = Exp()
    drv = TOmni(exp.get_model(serve=True), input_size=(96, 160),
                num_classes=exp.num_classes, device="cpu")
    calls = []
    msda = interaction.ms_deform_attn

    def recording(*a, **k):
        calls.append(a[0].dtype)
        return msda(*a, **k)

    monkeypatch.setattr(interaction, "ms_deform_attn", recording)
    for f in _frames(2, 96, 160, seed=3):
        out = drv.update(f)
        assert len(out) == 3 and out[0].shape[1:] == (5,)
    assert calls == [torch.bfloat16] * 2
