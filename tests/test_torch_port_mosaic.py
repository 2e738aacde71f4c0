"""The port's mosaic detection data path (unicorn_torch/data: the numpy
warps, random_perspective, TrainTransform, MosaicDetection, DetLoader and
ExpDet's loader) against cv2 and the JAX package's (which warps and
resizes with cv2), on the CPU in the same process, with the same inputs
and seeds. JAX's code draws from the process-global `random` /
`np.random`, seeded here with its `seed_everything(s)`; the port's takes
generators seeded s.

Tolerances (each the bound asserted; what this OpenCV 5.0 build measured
beside it):
  * getRotationMatrix2D: equal.
  * warp_affine / warp_perspective (uint8): within 1 gray level of cv2,
    at most 0.1% of the values differing; equal where cv2 runs its AVX-512
    warp kernels (as here; 0 differ), and for channel counts other than
    1, 3 and 4 (OpenCV's fixed-point path) on every CPU.
  * boxes of random_perspective and labels of the transforms, the mosaic
    and the loader: within 1e-6 (boxes) and 1e-4 (labels); equal here.
  * images through TrainTransform, MosaicDetection, DetLoader and
    ExpDet's loader (the warp, resizes, the blend and the HSV jitter, whose
    port is exact): as warp_affine, equal where cv2 runs its AVX-512 warp
    kernels (0 differ here), else within 1 gray level on at most 0.1% of
    the values.
"""
import json
import os
import random
import shutil

import cv2
import numpy as np
import pytest

from unicorn_torch.data import loader as tl
from unicorn_torch.data import mosaic as tm
from unicorn_torch.data import transforms as tt
from unicorn_tpu.data import loader as jl
from unicorn_tpu.data import mosaic as jm
from unicorn_tpu.data import transforms as jt

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_fixtures")
# OpenCV's warp kernels run 16 float lanes where its AVX-512 code is
# dispatched (cv::CPU_AVX_512SKX = 256), as the port's warps assume
AVX512 = ("AVX512-SKX" in cv2.getCPUFeaturesLine()
          and cv2.checkHardwareSupport(256))
TRANSFORM_FIELDS = ("mosaic_prob", "mixup_prob", "hsv_prob", "flip_prob",
                    "degrees", "translate", "mosaic_scale", "mixup_scale",
                    "shear", "enable_mixup", "max_labels")


def _assert_levels(a, b, what, exact=False):
    """uint8-valued arrays: equal where cv2 runs its AVX-512 warp kernels
    (which the port's warps follow) or where `exact`; else within 1 gray
    level, at most 0.1% of the values differing."""
    a, b = np.asarray(a, np.int64), np.asarray(b, np.int64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if AVX512 or exact:
        np.testing.assert_array_equal(a, b, err_msg=str(what))
    d = np.abs(a - b)
    assert d.max(initial=0) <= 1, (what, d.max())
    assert (d > 0).mean() <= 0.001, (what, (d > 0).mean())


def _assert_warp(out, ref, what, fixed_point=False):
    assert out.dtype == np.uint8, what
    _assert_levels(out, ref, what, exact=fixed_point)


def _perspective_matrix(rng, h, w, border):
    """random_perspective's matrix for a (h, w) image grown by border."""
    height, width = h + 2 * border[0], w + 2 * border[1]
    C = np.eye(3)
    C[:2, 2] = -w / 2, -h / 2
    R = np.eye(3)
    R[:2] = cv2.getRotationMatrix2D((0, 0), rng.uniform(-10, 10),
                                    rng.uniform(0.1, 2.0))
    S = np.eye(3)
    S[0, 1], S[1, 0] = np.tan(rng.uniform(-2, 2, 2) * np.pi / 180)
    T = np.eye(3)
    T[:2, 2] = rng.uniform(0.4, 0.6, 2) * (width, height)
    return T @ S @ R @ C, (width, height)


def test_get_rotation_matrix_2d_exact():
    for angle, centre, scale in ((0.0, (0, 0), 1.0), (3.3, (0, 0), 1.2),
                                 (-7.25, (10.5, -3.0), 0.3),
                                 (90.0, (640, 400), 2.0), (-180, (1, 2), 0.1)):
        np.testing.assert_array_equal(
            tt.get_rotation_matrix_2d(angle, centre, scale),
            cv2.getRotationMatrix2D(centre, angle, scale))


@pytest.mark.parametrize("channels", [1, 3, 4, 2, 5])
def test_warp_affine_matches_cv2(channels):
    """Under random_perspective's matrices (borders kept, grown, cut) at
    widths that are and are not multiples of the vector, the identity, an
    integer shift and a map whose source lies far outside the image;
    images with border 114, 2 and 5 channels as masks with border 0."""
    rng = np.random.RandomState(channels)
    border = 0 if channels in (2, 5) else 114
    for t, (h, w) in enumerate([(160, 240), (97, 131), (64, 64), (40, 150),
                                (33, 17)]):
        shape = (h, w) if channels == 1 else (h, w, channels)
        img = rng.randint(0, 256, shape, dtype=np.uint8)
        if channels in (2, 5):
            img = (img > 127).astype(np.uint8)
        mats = [_perspective_matrix(rng, h, w, b) for b in
                ((0, 0), (-h // 4, -w // 4), (h // 5, w // 7))]
        mats += [(np.eye(3), (w, h)),
                 (np.array([[1, 0, 3], [0, 1, -2], [0, 0, 1.0]]),
                  (w + 5, h - 3)),
                 (np.array([[0.5, 0.1, 5e3], [-0.1, 0.5, -4e3], [0, 0, 1]]),
                  (w, h))]
        for k, (M, dsize) in enumerate(mats):
            ref = cv2.warpAffine(img, M[:2], dsize=dsize,
                                 borderValue=(border,) * 4)
            out = tt.warp_affine(img, M[:2], dsize, border)
            _assert_warp(out, ref, (channels, t, k),
                         fixed_point=channels not in (1, 3, 4))


def test_warp_perspective_matches_cv2():
    rng = np.random.RandomState(7)
    for h, w in ((160, 240), (61, 93)):
        img = rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
        for _ in range(3):
            M = np.eye(3)
            M[:2, :2] += rng.uniform(-0.1, 0.1, (2, 2))
            M[2, :2] = rng.uniform(-5e-4, 5e-4, 2)
            M[:2, 2] = rng.uniform(-10, 10, 2)
            ref = cv2.warpPerspective(img, M, dsize=(w - 5, h + 3),
                                      borderValue=(114, 114, 114))
            _assert_warp(tt.warp_perspective(img, M, (w - 5, h + 3), 114),
                         ref, (h, w))
        ref = cv2.warpPerspective(img[:, :, 0], M, dsize=(w, h))
        _assert_warp(tt.warp_perspective(img[:, :, 0], M, (w, h)), ref, "1")


def _targets(rng, n, h, w, cols=5):
    xy = rng.uniform(0, 0.7, (n, 2)) * (w, h)
    wh = rng.uniform(0.05, 0.4, (n, 2)) * (w, h)
    out = [xy, np.minimum(xy + wh, (w, h)), rng.randint(0, 80, (n, 1))]
    if cols == 6:
        out.append(np.arange(1, n + 1)[:, None])
    return np.hstack(out).astype(np.float32)


def test_box_candidates_matches_jax():
    rng = np.random.RandomState(0)
    b1 = _targets(rng, 200, 100, 100)[:, :4].T * 1.5
    b2 = b1 * rng.uniform(0.2, 1.2, b1.shape)
    b2[:, :20] = b2[[2, 3, 0, 1], :20]  # inverted and degenerate boxes
    np.testing.assert_array_equal(tt.box_candidates(b1, b2),
                                  jt.box_candidates(b1, b2))


@pytest.mark.parametrize("case", ["grow", "mosaic", "masks", "perspective",
                                  "identity"])
def test_random_perspective_matches_jax(case):
    """Boxes within 1e-6 and images as warp_affine, the same draws
    consumed; masks (5 targets, 5 channels) warp and filter alike."""
    rng = np.random.RandomState(len(case))
    h, w = (80, 120) if case != "mosaic" else (128, 192)
    img = rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
    targets = _targets(rng, 5, h, w, cols=6)
    kw = dict(border=(-h // 4, -w // 4)) if case == "mosaic" else \
        dict(border=(3, 5)) if case == "grow" else {}
    if case == "identity":
        # M = T @ C, the identity: no warp at all
        kw = dict(degrees=0, translate=0, scale=(1, 1), shear=0)
    if case == "perspective":
        kw["perspective"] = 1e-4
    masks = (rng.rand(h, w, 5) > 0.5).astype(np.uint8) \
        if case == "masks" else None
    for seed in (0, 3, 11):
        random.seed(seed)
        ref = jt.random_perspective(img.copy(), targets.copy(), masks=masks,
                                    **kw)
        gen = random.Random(seed)
        out = tt.random_perspective(img.copy(), targets.copy(), masks=masks,
                                    rng=gen, **kw)
        assert gen.random() == random.random()
        _assert_warp(out[0], ref[0], (case, seed))
        np.testing.assert_allclose(out[1], ref[1], rtol=0, atol=1e-6)
        if masks is not None:
            _assert_warp(out[2], ref[2], (case, seed, "masks"),
                         fixed_point=True)
    if case == "identity":
        np.testing.assert_array_equal(out[0], img)


@pytest.mark.parametrize("case", ["5col", "6col", "empty", "fallback"])
def test_train_transform_matches_jax(case):
    rng = np.random.RandomState(len(case))
    img = rng.randint(0, 256, (90, 121, 3), dtype=np.uint8)
    targets = _targets(rng, 6, 90, 121, cols=6 if case == "6col" else 5)
    if case == "empty":
        targets = targets[:0]
    if case == "fallback":  # boxes that the letterbox shrinks under 1 px
        targets[:, 2:4] = targets[:, 0:2] + 0.5
    for seed in (1, 2):
        random.seed(seed)
        np.random.seed(seed)
        ref = jt.TrainTransform(max_labels=10)(img.copy(), targets.copy(),
                                               (64, 96))
        gen, np_gen = random.Random(seed), np.random.RandomState(seed)
        out = tt.TrainTransform(max_labels=10)(img.copy(), targets.copy(),
                                               (64, 96), rng=gen,
                                               np_rng=np_gen)
        assert gen.random() == random.random()
        assert np_gen.uniform() == np.random.uniform()
        _assert_levels(out[0], ref[0], (case, seed))
        assert out[1].shape == ref[1].shape
        np.testing.assert_allclose(out[1], ref[1], rtol=0, atol=1e-4)


def test_get_mosaic_coordinate_matches_jax():
    for i in range(4):
        for xc, yc, w, h in ((48, 32, 96, 64), (10, 70, 40, 90),
                             (150, 5, 200, 30), (96, 64, 1, 1)):
            assert tm.get_mosaic_coordinate(i, xc, yc, w, h, 64, 96) == \
                jm.get_mosaic_coordinate(i, xc, yc, w, h, 64, 96)


class _Items:
    """In-memory detection items of several sizes: `pull_item(i)` ->
    (img uint8, labels (N, 5) [xyxy, cls], (h, w), id); `annotations` as
    COCODataset holds them. Items in `empty` have no labels."""

    def __init__(self, n, seed, empty=()):
        rng = np.random.RandomState(seed)
        self.images, self.annotations = [], []
        for i in range(n):
            h, w = rng.randint(40, 100), rng.randint(50, 140)
            self.images.append(rng.randint(0, 256, (h, w, 3), np.uint8))
            labels = _targets(rng, 0 if i in empty else rng.randint(1, 7),
                              h, w)
            self.annotations.append((labels, (h, w), f"{i}.jpg"))

    def __len__(self):
        return len(self.images)

    def pull_item(self, i):
        labels, hw, _ = self.annotations[i]
        return self.images[i].copy(), labels.copy(), hw, np.array([i])


def _mosaics(items, **kw):
    fields = dict(img_size=(64, 96), mosaic_prob=kw.pop("mosaic_prob", 1.0),
                  mixup_prob=kw.pop("mixup_prob", 1.0), **kw)
    return (jm.MosaicDetection(items, preproc=jt.TrainTransform(30),
                               **fields),
            tm.MosaicDetection(items, preproc=tt.TrainTransform(30),
                               **fields))


@pytest.mark.parametrize("case", ["mosaic_mixup", "mosaic", "closed"])
def test_mosaic_detection_matches_jax(case):
    """Items drawn after random.seed(s) / np.random.seed(s) and from
    generators seeded s: labels within 1e-4, images as TrainTransform,
    the same draws consumed. Items 2 and 5 have no labels, so mixup's
    redraw loop runs."""
    items = _Items(8, 0, empty=(2, 5))
    jmos, tmos = _mosaics(items, enable_mixup=case == "mosaic_mixup")
    if case == "closed":
        jmos.close_mosaic()
        tmos.close_mosaic()
        assert not (tmos.enable_mosaic or tmos.enable_mixup)
    for seed in range(4):
        random.seed(seed)
        np.random.seed(seed)
        gen, np_gen = random.Random(seed), np.random.RandomState(seed)
        for idx in (0, 2, 7):
            ref = jmos[idx]
            out = tmos.get_item(idx, rng=gen, np_rng=np_gen)
            _assert_levels(out[0], ref[0], (case, seed, idx))
            np.testing.assert_allclose(out[1], ref[1], rtol=0, atol=1e-4)
            assert tuple(out[2]) == tuple(ref[2])
            np.testing.assert_array_equal(out[3], ref[3])
        assert gen.random() == random.random()
        assert np_gen.uniform() == np.random.uniform()


def test_mixup_redraws_until_labels():
    """Mixup alone on an origin whose item ids are all empty but one: the
    port's redraw (labels read without the image) draws JAX's indices."""
    items = _Items(6, 1, empty=(0, 1, 2, 3, 4))
    jmos, tmos = _mosaics(items)
    origin = np.full((64, 96, 3), 90, np.uint8)
    labels = np.array([[5, 5, 40, 30, 1]], np.float32)
    for seed in range(3):
        random.seed(seed)
        ref = jmos.mixup(origin.copy(), labels.copy(), (64, 96))
        gen = random.Random(seed)
        out = tmos.mixup(origin.copy(), labels.copy(), (64, 96), rng=gen)
        assert gen.random() == random.random()
        np.testing.assert_array_equal(out[0], ref[0])
        np.testing.assert_allclose(out[1], ref[1], rtol=0, atol=1e-4)


class _Indexed:
    """An item per index whose image and label encode the index."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def _item(self, i):
        return (np.full((2, 2, 3), i, np.float32),
                np.full((3, 5), i, np.float32), (2, 2), np.array([i]))

    def __getitem__(self, i):
        return self._item(i)

    def get_item(self, i, *, rng, np_rng):
        return self._item(i)


def _order(loader, n):
    return [loader._next_index() for _ in range(n)]


def test_det_loader_order_and_set_rank_match_jax():
    ds = _Indexed(11)
    for shuffle in (True, False):
        j = jl.DetLoader(ds, 3, seed=4, shuffle=shuffle)
        t = tl.DetLoader(ds, 3, seed=4, shuffle=shuffle)
        assert _order(t, 30) == _order(j, 30)
        jb, tb = j._make_batch(), t._make_batch()
        for a, b in zip(jb, tb):
            np.testing.assert_array_equal(a, b)
    j = jl.DetLoader(ds, 2, seed=9).set_rank(1, 3)
    t = tl.DetLoader(ds, 2, seed=9).set_rank(1, 3)
    assert sorted(t._order) == [1, 4, 7, 10]
    assert _order(t, 12) == _order(j, 12)
    assert t._py_rng.random() == random.random()
    assert t._np_rng.uniform() == np.random.uniform()


def test_det_loader_mosaic_batches_match_jax():
    """Two batches of B = 3 from loaders seeded 5 over MosaicDetection,
    JAX's after seed_everything(5); then close_mosaic and one more."""
    items = _Items(7, 2, empty=(3,))
    jmos, tmos = _mosaics(items)
    jl.seed_everything(5)
    j = jl.DetLoader(jmos, 3, seed=5)
    t = tl.DetLoader(tmos, 3, seed=5)
    assert t.dataset is tmos
    for k in range(3):
        if k == 2:
            jmos.close_mosaic()
            tmos.close_mosaic()
        jb, tb = j._make_batch(), t._make_batch()
        assert tb[0].shape == (3, 64, 96, 3) and tb[1].shape == (3, 30, 5)
        assert tb[0].dtype == np.float32
        _assert_levels(tb[0], jb[0], k)
        np.testing.assert_allclose(tb[1], jb[1], rtol=0, atol=1e-4)


def _exp_pairs():
    from unicorn_torch.exp import det as tdet
    from unicorn_torch.exp import det_mask as tdm
    from unicorn_torch.exp import track as ttrack
    from unicorn_torch.exp import track_mask as ttm
    from unicorn_tpu.exp import det as jdet
    from unicorn_tpu.exp import det_mask as jdm
    from unicorn_tpu.exp import track as jtrack
    from unicorn_tpu.exp import track_mask as jtm

    return [(jdet.ExpDet, tdet.ExpDet), (jtrack.ExpTrack, ttrack.ExpTrack),
            (jdm.ExpDetMask, tdm.ExpDetMask),
            (jtm.ExpTrackMask, ttm.ExpTrackMask)]


def test_exp_fields_match_jax():
    """ExpDet's fields equal JAX's vars() but the port's own (seed,
    output_dir); each of the four exps' transform fields equal JAX's."""
    pairs = _exp_pairs()
    jv, tv = vars(pairs[0][0]()), vars(pairs[0][1]())
    assert set(tv) - set(jv) == {"seed", "output_dir"}
    assert set(jv) <= set(tv)
    assert {k: tv[k] for k in jv} == jv
    for jcls, tcls in pairs:
        jv, tv = vars(jcls()), vars(tcls())
        assert {k: tv[k] for k in TRANSFORM_FIELDS} == \
            {k: jv[k] for k in TRANSFORM_FIELDS}, tcls.__name__


def _coco_layout(root):
    """A COCO train2017 layout of four fixture JPEGs (one without boxes)."""
    names = ["small_422_q75.jpg", "small_exif6.jpg", "davis_480x854.jpg",
             "small_444_q100.jpg"]
    rng = np.random.RandomState(3)
    images, anns = [], []
    for i, name in enumerate(names):
        dst = root / "coco" / "train2017" / f"{i + 1:012d}.jpg"
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(os.path.join(FIXTURES, name), dst)
        h, w = cv2.imread(str(dst)).shape[:2]
        images.append({"id": i + 1, "file_name": dst.name, "width": w,
                       "height": h})
        for _ in range(0 if i == 3 else 3):
            x, y = rng.uniform(0, 0.6, 2) * (w, h)
            bw, bh = rng.uniform(0.1, 0.4, 2) * (w, h)
            anns.append({"id": len(anns) + 1, "image_id": i + 1,
                         "category_id": int(rng.randint(1, 4)),
                         "bbox": [x, y, bw, bh], "area": bw * bh,
                         "iscrowd": 0})
    (root / "coco" / "annotations").mkdir()
    with open(root / "coco" / "annotations" / "instances_train2017.json",
              "w") as f:
        json.dump({"images": images, "annotations": anns, "categories": [
            {"id": k, "name": str(k)} for k in (1, 2, 3)]}, f)


def test_exp_det_get_data_loader_matches_jax(tmp_path, monkeypatch):
    """ExpDet.get_data_loader over an on-disk COCO layout: a DetLoader
    over MosaicDetection whose one-worker batches equal JAX's loader's
    after seed_everything(0); with two workers it gives batches of the
    same shapes."""
    from unicorn_torch.exp.det import ExpDet
    from unicorn_tpu.exp.det import ExpDet as JExpDet

    _coco_layout(tmp_path)
    monkeypatch.setenv("UNICORN_DATADIR", str(tmp_path))
    jexp, texp = JExpDet(), ExpDet()
    for e in (jexp, texp):
        e.input_size = (64, 96)
    j, t = jexp.get_data_loader(2), texp.get_data_loader(2)
    assert isinstance(t, tl.DetLoader)
    assert isinstance(t.dataset, tm.MosaicDetection)
    assert len(t.dataset) == 4
    jl.seed_everything(0)
    for k in range(2):
        jb, tb = j._make_batch(), t._make_batch()
        assert tb[0].shape == (2, 64, 96, 3) and tb[1].shape == (2, 120, 5)
        _assert_levels(tb[0], jb[0], k)
        np.testing.assert_allclose(tb[1], jb[1], rtol=0, atol=1e-4)
    texp.data_num_workers = 2
    loader = texp.get_data_loader(2)
    try:
        images, labels = next(iter(loader))
    finally:
        loader.stop()
    assert loader.workers == 2
    assert images.shape == (2, 64, 96, 3) and labels.shape == (2, 120, 5)
    assert np.isfinite(images).all() and np.isfinite(labels).all()
