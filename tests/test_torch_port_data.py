"""The port's host data path (unicorn_torch/data: preproc, transforms,
datasets/omni, loader) against the JAX package's (which uses cv2), on the
CPU in the same process, with the same inputs and seeds. JAX's code draws
from the process-global `random` / `np.random`, seeded here with its
`seed_everything(s)`; the port's takes generators seeded s.

Tolerances (each the bound asserted; what this OpenCV 5.0 build measured
beside it):
  * BGR -> HSV (uint8, hue on 0-180): equal to cv2 on all 2**24 colours.
  * HSV -> BGR: within 1 gray level of cv2 on all 180 * 256 * 256 inputs
    through cv2's vector code and on 199,980 through its scalar code (the
    last W mod 32 pixels of a row); `augment_hsv` from the same np.random
    seed likewise, at widths with and without such pixels (0 differ here;
    a CPU whose cv2 converts in other blocks, or without fused
    multiply-adds, may round one level apart).
  * uint8 resize and letterbox: within 1 gray level of cv2, at most 1% of
    the values differing (0 here).
  * float32 mask resize (the d_rate shrink of TrainTransformIns): within
    1e-4 of cv2 (cv2's 1-, 3- and 4-channel float code rounds its
    weights differently: up to 3e-5 on 0/1 masks); letterbox_mask, cast
    to uint8: equal.
  * labels: equal (the same float ops on the same values).
  * batches of UniLoader, UniMaskLoader and InstLoader with one worker:
    task ids and labels equal, images within 1 gray level (equal here),
    masks within 1e-4.
"""
import random
import time

import cv2
import numpy as np
import pytest

from unicorn_torch.data import loader as tl
from unicorn_torch.data import preproc as tp
from unicorn_torch.data import transforms as tt
from unicorn_torch.data.datasets import omni as tomni
from unicorn_tpu.data import loader as jl
from unicorn_tpu.data import preproc as jp
from unicorn_tpu.data import transforms as jt
from unicorn_tpu.data.datasets import omni as jomni

SHAPES = [(1080, 1920, 800, 1422), (48, 56, 55, 64), (100, 200, 64, 128),
          (37, 91, 61, 150), (64, 64, 64, 64), (1, 5, 3, 9)]


def _assert_levels(a, b, what):
    """uint8-valued arrays within 1 gray level, at most 1% differing."""
    d = np.abs(np.asarray(a, np.int64) - np.asarray(b, np.int64))
    assert d.max(initial=0) <= 1, (what, d.max())
    assert (d > 0).mean() <= 0.01, (what, (d > 0).mean())


def _gens(seed):
    return random.Random(seed), np.random.RandomState(seed)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("channels", [1, 3, 5])
def test_resize_linear_uint8_matches_cv2(shape, channels):
    h, w, dh, dw = shape
    rng = np.random.RandomState(h * w + channels)
    img = (rng.rand(h, w, channels) * 255).astype(np.uint8)
    if channels == 1:
        img = img[:, :, 0]
    ref = cv2.resize(img, (dw, dh), interpolation=cv2.INTER_LINEAR)
    out = tp.resize_linear(img, (dw, dh))
    assert out.shape == ref.shape and out.dtype == np.uint8
    _assert_levels(out, ref, shape)


@pytest.mark.parametrize("shape", SHAPES[:4])
@pytest.mark.parametrize("channels", [1, 2, 3, 4, 7])
def test_resize_linear_float_masks_match_cv2(shape, channels):
    h, w, dh, dw = shape
    rng = np.random.RandomState(channels)
    masks = np.zeros((h, w, channels), np.float32)
    for k in range(channels):
        y0, x0 = rng.randint(0, h // 2 + 1), rng.randint(0, w // 2 + 1)
        masks[y0:y0 + rng.randint(1, h // 2 + 2),
              x0:x0 + rng.randint(1, w // 2 + 2), k] = 1.0
    ref = cv2.resize(masks, (dw, dh), interpolation=cv2.INTER_LINEAR)
    ref = ref.reshape(dh, dw, channels)
    out = tp.resize_linear(masks, (dw, dh))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(out.astype(np.uint8), ref.astype(np.uint8))


@pytest.mark.parametrize("shape", [(1080, 1920), (48, 56), (100, 200),
                                   (64, 64), (300, 120)])
def test_letterbox_mask_and_val_transform_match_jax(shape):
    rng = np.random.RandomState(shape[0])
    img = (rng.rand(*shape, 3) * 255).astype(np.uint8)
    masks = (rng.rand(*shape, 2) > 0.4).astype(np.float32)
    for size in ((64, 64), (96, 160), (800, 1280)):
        out, r = tp.letterbox(img, size)
        ref, r_ref = jp.letterbox(img, size)
        assert r == r_ref and out.dtype == np.float32
        _assert_levels(out, ref, (shape, size))
        np.testing.assert_array_equal(out[ref == 114], 114)
        m, rm = tp.letterbox_mask(masks, size)
        m_ref, _ = jp.letterbox_mask(masks, size)
        np.testing.assert_array_equal(m, m_ref)
    v, v_res = tt.ValTransform()(img, None, (96, 160))
    v_ref, v_res_ref = jt.ValTransform()(img, None, (96, 160))
    _assert_levels(v, v_ref, "ValTransform")
    np.testing.assert_array_equal(v_res, v_res_ref)
    m2, _ = tp.letterbox_mask(masks[:, :, 0], (64, 64))
    np.testing.assert_array_equal(m2, jp.letterbox_mask(masks[:, :, 0],
                                                        (64, 64))[0])


def test_bgr2hsv_exact_and_hsv2bgr_within_a_level():
    """Over every colour: the tables `augment_hsv` reads, which hold the
    two functions' values, against cv2."""
    hsv_of, bgr_of = tt._colour_tables()
    code = np.arange(1 << 24, dtype=np.uint32)
    bgr = np.stack([code & 255, (code >> 8) & 255, code >> 16], -1)
    bgr = bgr.astype(np.uint8).reshape(4096, 4096, 3)
    ref = cv2.cvtColor(bgr, cv2.COLOR_BGR2HSV).reshape(-1, 3).astype(np.uint32)
    np.testing.assert_array_equal(
        hsv_of, ref[:, 0] | (ref[:, 1] << 8) | (ref[:, 2] << 16))
    np.testing.assert_array_equal(tt.bgr2hsv(bgr[:64]),
                                  ref.reshape(4096, 4096, 3)[:64])

    code = np.arange(180 << 16, dtype=np.uint32)
    hsv = np.stack([code >> 16, (code >> 8) & 255, code & 255], -1)
    hsv = hsv.astype(np.uint8).reshape(180 * 256, 256, 3)
    ref = cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR).reshape(-1, 3)
    mine = bgr_of.view(np.uint8).reshape(-1, 4)[:, :3]
    _assert_levels(mine, ref, "hsv2bgr")
    _assert_levels(tt.hsv2bgr(hsv[:512]), ref.reshape(hsv.shape)[:512],
                   "hsv2bgr arithmetic")
    # an image 30 pixels wide: every pixel through cv2's scalar code
    tail = hsv.reshape(-1, 3)[np.random.RandomState(0).choice(
        len(code), 199_980, replace=False)].reshape(-1, 30, 3)
    _assert_levels(tt.hsv2bgr(tail, vector=False),
                   cv2.cvtColor(tail, cv2.COLOR_HSV2BGR), "hsv2bgr scalar")


@pytest.mark.parametrize("seed,width", [(0, 160), (5, 120), (2, 31)])
def test_augment_hsv_matches_jax(seed, width):
    img = (np.random.RandomState(seed).rand(90, width, 3) * 255
           ).astype(np.uint8)
    a, b = img.copy(), img.copy()
    np.random.seed(seed)
    jt.augment_hsv(a)
    nr = np.random.RandomState(seed)
    tt.augment_hsv(b, nr)
    assert nr.uniform() == np.random.uniform()  # the same draws consumed
    _assert_levels(b, a, "augment_hsv")


def _omni_inputs(seed, n=3, hw=(90, 120)):
    rng = np.random.RandomState(seed)
    img = (rng.rand(*hw, 3) * 255).astype(np.uint8)
    x0 = rng.uniform(0, hw[1] - 40, n)
    y0 = rng.uniform(0, hw[0] - 40, n)
    wh = rng.uniform(4, 38, (n, 2))
    tg = np.stack([x0, y0, x0 + wh[:, 0], y0 + wh[:, 1],
                   rng.randint(0, 8, n), np.arange(1, n + 1)], 1)
    masks = np.zeros((*hw, n), np.float32)
    for k in range(n):
        masks[int(y0[k]):int(y0[k] + wh[k, 1]),
              int(x0[k]):int(x0[k] + wh[k, 0]), k] = 1.0
    return img, tg.astype(np.float32), masks


@pytest.mark.parametrize("joint,flip", [(False, False), (True, True),
                                        (True, False)])
@pytest.mark.parametrize("sot", [False, True])
def test_train_transforms_match_jax(joint, flip, sot):
    """TrainTransformOmni, TrainTransformIns and TrainTransform4Tasks on
    the same inputs and seeds; SOT targets carry no tid column."""
    size = (64, 96)
    for seed in range(3):
        img, tg, masks = _omni_inputs(seed)
        if sot:
            tg, masks = tg[:1, :5], masks[:, :, :1]
        cases = [
            (jt.TrainTransformOmni(8), tt.TrainTransformOmni(8), False),
            (jt.TrainTransformIns(8, d_rate=4), tt.TrainTransformIns(
                8, d_rate=4), True),
            (jt.TrainTransform4Tasks(8, d_rate=2), tt.TrainTransform4Tasks(
                8, d_rate=2), True)]
        for jf, tf, with_masks in cases:
            args = (masks,) if with_masks else ()
            random.seed(seed)
            np.random.seed(seed)
            ref = jf(img.copy(), tg.copy(), *args, size, joint=joint,
                     flip=flip)
            r, nr = _gens(seed)
            out = tf(img.copy(), tg.copy(), *args, size, joint=joint,
                     flip=flip, rng=r, np_rng=nr)
            assert r.random() == random.random()
            _assert_levels(out[0], ref[0], type(tf).__name__)
            np.testing.assert_array_equal(out[1], ref[1])
            if with_masks:
                np.testing.assert_allclose(out[2], ref[2], rtol=0, atol=1e-4)
    # 4 tasks without masks: the box transform, masks None
    r, nr = _gens(0)
    assert tt.TrainTransform4Tasks(8)(img, tg, None, size, rng=r,
                                      np_rng=nr)[2] is None


def test_all_filtered_fallback_matches_jax():
    """Every box under 1 px after the letterbox: the un-augmented boxes,
    labels and tids come back (and zero masks), as JAX's
    (tests/test_data.py:516)."""
    img = np.full((128, 128, 3), 90, np.uint8)
    targets = np.array([[10, 10, 12, 12, 2, 5]], np.float32)
    masks = np.zeros((128, 128, 1), np.float32)
    masks[10:12, 10:12, 0] = 1.0
    r, nr = _gens(0)
    t = tt.TrainTransformIns(max_labels=4, flip_prob=0.0, hsv_prob=0.0)
    img_t, labels, masks_t = t(img.copy(), targets, masks, (64, 64),
                               joint=True, flip=False, rng=r, np_rng=nr)
    assert labels[0, 0] == 2 and labels[0, 5] == 5
    np.testing.assert_allclose(labels[0, 1:5], [5.5, 5.5, 1.0, 1.0])
    assert labels[1:].sum() == 0 and masks_t.sum() == 0
    ref = jt.TrainTransformIns(max_labels=4, flip_prob=0.0, hsv_prob=0.0)(
        img.copy(), targets, masks, (64, 64), joint=True, flip=False)
    np.testing.assert_array_equal(labels, ref[1])
    np.testing.assert_array_equal(masks_t, ref[2])
    o = tt.TrainTransformOmni(4, hsv_prob=0.0)(img.copy(), targets[:, :5],
                                               (64, 64), rng=r, np_rng=nr)
    assert o[1][0, 5] == 1 and o[1][0, 0] == 2


class Sub:
    """An in-memory sub-dataset: pull_item_omni returns fresh frames from
    its own seeded generator (so call order fixes the data), with masks
    when `masked`. It draws nothing from `rng` (the port passes its
    loader's; JAX's omni passes none)."""

    def __init__(self, n, seed, n_obj, masked=False, hw=(90, 120)):
        self.n, self.rng, self.n_obj = n, np.random.RandomState(seed), n_obj
        self.masked, self.hw, self.calls = masked, hw, []

    def __len__(self):
        return self.n

    def pull_item_omni(self, seq_id, num_frames=2, rng=None):
        self.calls.append(seq_id)
        out = []
        for _ in range(num_frames):
            img, tg, masks = _omni_inputs(self.rng.randint(1 << 30),
                                          self.n_obj, self.hw)
            if self.n_obj == 1:
                tg = tg[:, :5]
            out.append((img, tg, masks) if self.masked else (img, tg))
        return out


def _plus(mod, masked, mode="alter"):
    sot = mod.OmniDataset([Sub(5, 1, 1, masked), Sub(9, 2, 1, masked)],
                          samples_per_epoch=3)
    mot = mod.OmniDataset([Sub(7, 3, 4, masked)], p_datasets=[2],
                          samples_per_epoch=3)
    return mod.OmniDatasetPlus(sot, mot, 6, mode=mode, mot_weight=0.7)


@pytest.mark.parametrize("mode", ["alter", "joint"])
def test_omni_draws_match_jax(mode):
    def walk(plus, draw):
        out = []
        for i in range(12):
            ds, inner, task = draw(plus)
            sub = inner[0] if inner is not None else None
            out.append((task, plus.sot_dataset.datasets.index(sub)
                        if task == 1 else 0, inner[1]))
            if i % 3 == 2:
                plus.alter_task()
        return out

    random.seed(11)
    ref = walk(_plus(jomni, False, mode), lambda p: p.sample_spec(0))
    rng = random.Random(11)
    got = walk(_plus(tomni, False, mode), lambda p: p.sample_spec(0, rng))
    assert got == ref and len({t for t, _, _ in got}) == 2
    # the ablations: one group only
    solo = tomni.OmniDatasetPlus(None, _plus(tomni, False).mot_dataset)
    assert {solo.sample_spec(0, rng)[2] for _ in range(4)} == {2}
    solo = tomni.OmniDatasetPlus(_plus(tomni, False).sot_dataset, None)
    assert {solo.sample_spec(0, rng)[2] for _ in range(4)} == {1}
    frames, task = solo.load_spec(solo.sample_spec(0, rng), rng)
    assert task == 1 and len(frames) == 2


def _compare_batches(jb, tb, masks):
    assert len(jb) == len(tb) == (4 if masks else 3)
    _assert_levels(tb[0], jb[0], "images")
    np.testing.assert_array_equal(tb[1], jb[1])
    np.testing.assert_array_equal(tb[2], jb[2])
    if masks:
        np.testing.assert_allclose(tb[3], jb[3], rtol=0, atol=1e-4)


@pytest.mark.parametrize("kind", ["uni", "uni_mask", "inst"])
def test_loader_batches_match_jax(kind):
    """Three batches of each loader, one worker, seed 3, from the same
    in-memory datasets, against JAX's; the first after a multiscale size
    change."""
    seed, size = 3, (64, 96)

    def build(mod_l, mod_t, mod_o):
        if kind == "inst":
            return mod_l.InstLoader(Sub(6, 4, 3, True),
                                    mod_t.TrainTransformIns(10, d_rate=4),
                                    2, size, seed=seed)
        if kind == "uni":
            return mod_l.UniLoader(_plus(mod_o, False),
                                   mod_t.TrainTransformOmni(10), 2, size,
                                   seed=seed)
        return mod_l.UniMaskLoader(_plus(mod_o, True),
                                   mod_t.TrainTransformIns(10, d_rate=2), 2,
                                   size, seed=seed)

    jl.seed_everything(seed)
    jload = build(jl, jt, jomni)
    jload.set_input_size((96, 128))
    jbs = [jload._make_batch() for _ in range(3)]
    tload = build(tl, tt, tomni)
    tload.set_input_size((96, 128))
    tbs = [tload._make_batch() for _ in range(3)]
    for jb, tb in zip(jbs, tbs):
        if kind == "inst":
            assert len(tb) == 3 and tb[0].shape == (2, 96, 128, 3)
            _assert_levels(tb[0], jb[0], "images")
            np.testing.assert_array_equal(tb[1], jb[1])
            np.testing.assert_allclose(tb[2], jb[2], rtol=0, atol=1e-4)
        else:
            assert tb[0].shape == (2, 2, 96, 128, 3)
            _compare_batches(jb, tb, kind == "uni_mask")
    if kind != "inst":
        assert [int(b[2][0]) for b in tbs] == [1, 2, 1]  # alternation


def test_loader_keeps_built_batches_on_full_queue():
    """The worker builds each batch once and retries the put on a full
    queue: no batch is dropped, so every sample drawn arrives, in order
    (JAX's tests/test_data.py:416)."""
    class Counting:
        def __init__(self):
            self.count = 0

        def __len__(self):
            return 4

        def pull_item_omni(self, idx, num_frames=1, rng=None):
            res = np.array([[0, 0, 8, 8, self.count, 1]], np.float32)
            self.count += 1
            return [(np.zeros((16, 16, 3), np.uint8), res,
                     np.zeros((16, 16, 1), np.float32))]

    loader = tl.InstLoader(Counting(), tt.TrainTransformIns(
        2, hsv_prob=0.0, d_rate=4), batch_size=2, input_size=(16, 16),
        prefetch=1)
    it = iter(loader)
    time.sleep(1.3)  # the worker fills the queue and times out one put
    seen = [int(lab[0, 0]) for _ in range(4) for lab in next(it)[1]]
    loader.stop()
    assert seen == list(range(8)), seen


def test_set_rank_reseeds_like_jax():
    """Rank-disjoint sampling (tests/test_data.py:192): the ranks' streams
    differ, and each equals JAX's for that rank (its `_rng`, and the
    globals it seeds)."""
    streams = []
    for rank in (0, 1):
        u = tl.UniLoader(None, None, 4, (64, 64), seed=2).set_rank(rank, 2)
        j = jl.UniLoader(None, None, 4, (64, 64), seed=2).set_rank(rank, 2)
        s = [u._rng.random() for _ in range(8)]
        assert s == [j._rng.random() for _ in range(8)]
        assert u._py_rng.random() == random.random()
        assert u._np_rng.uniform() == np.random.uniform()
        streams.append(s)
        i = tl.InstLoader(None, None, 4, (64, 64), seed=2).set_rank(rank, 2)
        assert [i._rng.random() for _ in range(8)] == s
    assert streams[0] != streams[1]


def test_uni_loader_workers_keep_one_task_a_batch():
    """workers > 1: the shapes hold and every batch keeps one task while
    the alternation still flips (tests/test_data.py:251)."""
    class DS:
        def __init__(self):
            self.task = 1

        def pull_item(self, _):
            img = (np.random.rand(48, 64, 3) * 255).astype(np.uint8)
            res = np.array([[5, 5, 30, 30, 0, 1]], np.float32)
            return [(img, res), (img, res)], self.task

        def alter_task(self):
            self.task = 3 - self.task

    loader = tl.UniLoader(DS(), tt.TrainTransformOmni(max_labels=8),
                          batch_size=3, input_size=(64, 64), workers=3)
    it = iter(loader)
    seen = set()
    for _ in range(6):
        imgs, tgts, tids = next(it)
        assert imgs.shape == (3, 2, 64, 64, 3) and tgts.shape == (3, 2, 8, 6)
        assert len(set(tids.tolist())) == 1
        seen.add(int(tids[0]))
    loader.stop()
    for t in loader._threads:
        t.join(timeout=10)
    assert seen == {1, 2} and not any(t.is_alive() for t in loader._threads)


def test_uni_mask_loader_four_task_batch():
    """A batch mixing a VOS sample (frames with masks) and an SOT sample
    (frames without): the box sample gets zero masks of the batch's shape
    (tests/test_data.py:211)."""
    class MixedDS:
        def __init__(self):
            self.call = 0

        def pull_item(self, _):
            img = (np.random.rand(48, 64, 3) * 255).astype(np.uint8)
            res = np.array([[5, 5, 30, 30, 0, 1]], np.float32)
            self.call += 1
            if self.call % 2:
                masks = np.zeros((48, 64, 1), np.float32)
                masks[8:28, 8:28, 0] = 1.0
                return [(img, res, masks), (img, res, masks)], 3
            return [(img, res), (img, res)], 1

        def alter_task(self):
            pass

    loader = tl.UniMaskLoader(MixedDS(), tt.TrainTransform4Tasks(
        max_labels=10), batch_size=2, input_size=(64, 64))
    imgs, tgts, tids, masks = loader._make_batch()
    assert imgs.shape == (2, 2, 64, 64, 3) and tgts.shape == (2, 2, 10, 6)
    assert masks.shape == (2, 2, 10, 16, 16)
    assert set(tids.tolist()) == {1, 3}
    assert ((masks.reshape(2, -1).sum(1) > 0).sum()) == 1


def test_loader_raises_a_failed_batch():
    """A batch that fails to build is raised by next(), not waited for."""
    class Broken:
        def __len__(self):
            return 2

        def pull_item_omni(self, idx, num_frames=1, rng=None):
            raise OSError("unreadable frame")

    loader = tl.InstLoader(Broken(), tt.TrainTransformIns(2), 2, (16, 16))
    with pytest.raises(OSError, match="unreadable frame"):
        next(iter(loader))
    loader._threads[0].join(timeout=10)
    assert not loader._threads[0].is_alive()
