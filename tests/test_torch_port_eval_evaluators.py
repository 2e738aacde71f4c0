"""The port's evaluators (unicorn_torch/evaluators: COCOEvaluator,
COCOInstEvaluator, VOCEvaluator, MOTEvaluator, BDDEvaluator) against the
JAX package's on the CPU, with stub forwards that give both the same
detections, embeddings and masks (seeded numpy, keyed by the call count),
each package reading the data through its own datasets.

What is held equal: COCOEvaluator's result lists (exactly: the same float32
arithmetic on the same detections) and metrics, with device NMS and host
NMS, at batch 1 and at batch 2 over 3 images (the last batch not padded);
COCOInstEvaluator's box results and metrics, and its binary masks except
at pixels whose cv2 INTER_LINEAR value lies within 3e-5 of mask_thres
(resize_linear's bound against cv2's float resize; the count is printed);
VOCEvaluator's dict; MOTEvaluator's result dicts on the ByteTrack and SORT
paths, QDTrack / DeepSORT / MOTDT embedding paths and the MOTS path (ids,
boxes, scores, RLEs, the txt files); BDDEvaluator's scalabel frames, json
files and bitmask PNGs. `data/preproc.py resize_nearest` against
cv2.INTER_NEAREST over shrink and grow factors, odd sizes and 1-pixel
crops; `data/image_io.py write_png` through read_png, imread and PIL.

The JAX package's own evaluator cases (tests/test_coco_evaluator_e2e.py,
test_inst_evaluator_e2e.py, test_mot_evaluator_e2e.py, test_mots.py's
evaluate_omni_mots, test_legacy_trackers.py's evaluator loops,
test_bdd_e2e.py's evaluator and MOTS-dataset cases, test_eval.py's VOC
case) run again on the port's classes, through subclasses that take JAX's
calling convention (a params argument after the callables) and run on the
CPU.
"""
import json
import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import test_bdd_e2e as bdd_cases
import test_coco_evaluator_e2e as coco_cases
import test_eval as eval_cases
import test_inst_evaluator_e2e as inst_cases
import test_legacy_trackers as legacy_cases
import test_mot_evaluator_e2e as mot_cases
import test_mots as mots_cases
from unicorn_torch.data import image_io
from unicorn_torch.data import preproc as tpre
from unicorn_torch.data import transforms as ttr
from unicorn_torch.data.datasets import bdd as tbdd_ds
from unicorn_torch.data.datasets import coco as tcoco_ds
from unicorn_torch.data.datasets import voc as tvoc_ds
from unicorn_torch.evaluators import bdd_evaluator as tbdd
from unicorn_torch.evaluators import coco_evaluator as tcoco
from unicorn_torch.evaluators import coco_inst_evaluator as tinst
from unicorn_torch.evaluators import mot_evaluator as tmot
from unicorn_torch.evaluators import rle as trle
from unicorn_torch.evaluators import voc_evaluator as tvoc
from unicorn_tpu.data import transforms as jtr
from unicorn_tpu.data.datasets import bdd as jbdd_ds
from unicorn_tpu.data.datasets import coco as jcoco_ds
from unicorn_tpu.data.datasets import voc as jvoc_ds
from unicorn_tpu.evaluators import bdd_evaluator as jbdd
from unicorn_tpu.evaluators import coco_evaluator as jcoco
from unicorn_tpu.evaluators import coco_inst_evaluator as jinst
from unicorn_tpu.evaluators import coco_map as jmap
from unicorn_tpu.evaluators import mot_evaluator as jmot
from unicorn_tpu.evaluators import voc_evaluator as jvoc

MASK_BOUND = 3e-5   # resize_linear vs cv2's float INTER_LINEAR


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# ------------------------------------------------ adapters for JAX's cases
class PortCOCO(tcoco.COCOEvaluator):
    """The port's COCOEvaluator on the CPU, called as the JAX tests call
    JAX's: evaluate(forward(params, images), params)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, device="cpu", **kw)

    def evaluate(self, forward_fn, params, max_images=None):
        return super().evaluate(
            lambda x: torch.from_numpy(np.array(forward_fn(params, x))),
            max_images)


class PortInst(tinst.COCOInstEvaluator):
    def __init__(self, *a, **kw):
        super().__init__(*a, device="cpu", **kw)

    def evaluate(self, forward_fn, params, max_images=None):
        return super().evaluate(
            lambda x: tuple(torch.from_numpy(np.array(o))
                            for o in forward_fn(params, x)), max_images)


class PortVOC(tvoc.VOCEvaluator):
    def __init__(self, *a, **kw):
        super().__init__(*a, device="cpu", **kw)


class PortMOT(tmot.MOTEvaluator):
    def __init__(self, *a, **kw):
        super().__init__(*a, device="cpu", **kw)

    def evaluate(self, step_fn, params, **kw):
        return super().evaluate(lambda f: step_fn(params, f), **kw)

    def evaluate_omni(self, whole_fn, embed_fn, params, **kw):
        return super().evaluate_omni(
            lambda f: whole_fn(params, f),
            lambda a, b, c: embed_fn(params, a, b, c), **kw)

    def evaluate_omni_mots(self, whole_mask_fn, embed_fn, params, **kw):
        return super().evaluate_omni_mots(
            lambda f: whole_mask_fn(params, f),
            lambda a, b, c: embed_fn(params, a, b, c), **kw)


class PortBDD(tbdd.BDDEvaluator):
    def __init__(self, *a, **kw):
        super().__init__(*a, device="cpu", **kw)

    def evaluate_det(self, step_fn, params, **kw):
        return super().evaluate_det(lambda f: step_fn(params, f), **kw)


# ------------------------------------------------------------ COCO, inst
def _write_coco(root, n_images, hw, masks=False, seed=0):
    os.makedirs(os.path.join(root, "annotations"))
    os.makedirs(os.path.join(root, "val"))
    rng = np.random.RandomState(seed)
    images, anns = [], []
    for i in range(n_images):
        name = f"{i:04d}.jpg"
        cv2.imwrite(os.path.join(root, "val", name),
                    (rng.rand(*hw, 3) * 255).astype(np.uint8))
        images.append({"id": 7 + i, "file_name": name, "width": hw[1],
                       "height": hw[0]})
        for _ in range(3):
            x, y = int(rng.uniform(2, hw[1] / 2)), int(rng.uniform(2,
                                                                  hw[0] / 2))
            w, h = int(rng.uniform(8, hw[1] / 2)), int(rng.uniform(8,
                                                                  hw[0] / 2))
            a = {"id": len(anns) + 1, "image_id": 7 + i,
                 "category_id": int(rng.choice([1, 3])),
                 "bbox": [x, y, w, h], "area": w * h,
                 "iscrowd": int(rng.rand() < 0.2)}
            if masks:
                m = np.zeros(hw, np.uint8)
                m[y:y + h, x:x + w] = 1
                a["segmentation"] = trle.encode(m)
                a["area"] = int(m.sum())
            anns.append(a)
    with open(os.path.join(root, "annotations", "val.json"), "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": 1, "name": "a"},
                                  {"id": 3, "name": "b"}]}, f)


def _decoded(seed, n_images, test_size, A=48, C=3):
    """Per image a decoded (A, 5 + C) array: cxcywh in letterbox
    coordinates, sigmoid-range objectness and class scores (C = 3 > the 2
    categories: the class_ids guard runs)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_images):
        d = np.zeros((A, 5 + C), np.float32)
        d[:, 0] = rng.uniform(0, test_size[1], A)
        d[:, 1] = rng.uniform(0, test_size[0], A)
        d[:, 2:4] = rng.uniform(4, 30, (A, 2))
        d[:, 4] = rng.uniform(0, 1, A)
        d[:, 5:] = rng.uniform(0, 1, (A, C))
        out.append(d)
    return out


class _Recorder:
    """COCOMeanAP that records the detections it scores."""

    def __init__(self, base, store):
        self.base, self.store = base, store

    def __call__(self, gt, iou_type="bbox", *a, **kw):
        inner = self.base(gt, iou_type, *a, **kw)
        store = self.store

        class Rec:
            def evaluate(self, detections, img_ids=None):
                store.append((iou_type, [dict(d) for d in detections]))
                return inner.evaluate(detections, img_ids)
        return Rec()


@pytest.mark.parametrize("batch_size,device_nms",
                         [(1, True), (2, True), (2, False)])
def test_coco_evaluator_matches_jax(tmp_path, monkeypatch, batch_size,
                                    device_nms):
    hw, test_size = (72, 100), (64, 96)
    _write_coco(str(tmp_path), 3, hw)
    preds = _decoded(3, 3, test_size)
    seen = {"t": [], "j": []}

    def forward_t(images):
        i = forward_t.n
        forward_t.n += images.shape[0]
        seen["t"].append(images.shape[0])
        return torch.from_numpy(np.stack(preds[i:i + images.shape[0]]))

    def forward_j(params, images):
        i = forward_j.n
        forward_j.n += images.shape[0]
        return jnp.asarray(np.stack(preds[i:i + images.shape[0]]))

    forward_t.n = forward_j.n = 0
    got, want = [], []
    monkeypatch.setattr(tcoco, "COCOMeanAP", _Recorder(tcoco.COCOMeanAP, got))
    monkeypatch.setattr(jmap, "COCOMeanAP", _Recorder(jmap.COCOMeanAP, want))
    tds = tcoco_ds.COCODataset(str(tmp_path), "val.json", "val",
                               img_size=test_size, preproc=ttr.ValTransform())
    jds = jcoco_ds.COCODataset(str(tmp_path), "val.json", "val",
                               img_size=test_size, preproc=jtr.ValTransform())
    kw = dict(conf_thre=0.3, nms_thre=0.5, num_classes=3,
              batch_size=batch_size, use_device_nms=device_nms)
    mt = tcoco.COCOEvaluator(tds, test_size, device="cpu", **kw).evaluate(
        forward_t)
    mj = jcoco.COCOEvaluator(jds, test_size, **kw).evaluate(forward_j, None)
    assert seen["t"] == ([1, 1, 1] if batch_size == 1 else [2, 1])
    assert got == want and len(got[0][1]) > 5
    assert {d["category_id"] for d in got[0][1]} == {1, 3}
    mt.pop("infer_time_s"), mj.pop("infer_time_s")
    assert mt == mj and mt["n_images"] == 3
    # max_images cuts the set
    forward_t.n = 0
    assert tcoco.COCOEvaluator(tds, test_size, device="cpu", **kw).evaluate(
        forward_t, max_images=2)["n_images"] == 2


def test_coco_inst_evaluator_matches_jax(tmp_path, monkeypatch, capsys):
    hw, test_size, d_rate = (60, 90), (64, 64), 4
    _write_coco(str(tmp_path), 2, hw, masks=True, seed=1)
    rng = np.random.RandomState(5)
    K, Hm, Wm = 6, test_size[0] // d_rate, test_size[1] // d_rate
    outs = []
    for _ in range(2):
        dets = np.zeros((K, 7), np.float32)
        xy = rng.uniform(0, 40, (K, 2))
        dets[:, :4] = np.concatenate([xy, xy + rng.uniform(6, 24, (K, 2))],
                                     1)
        dets[:, 4] = rng.uniform(0.3, 1, K)
        dets[:, 5] = rng.uniform(0.3, 1, K)
        dets[:, 6] = rng.randint(0, 3, K)
        valid = rng.rand(K) < 0.8
        # smooth blobs: every level between 0 and 1 crosses mask_thres
        yy, xx = np.mgrid[:Hm, :Wm]
        masks = np.stack([np.exp(-((yy - rng.uniform(0, Hm)) ** 2
                                   + (xx - rng.uniform(0, Wm)) ** 2)
                                 / rng.uniform(4, 30))
                          for _ in range(K)]).astype(np.float32)
        outs.append((dets, valid, masks))

    def forward_t(images):
        forward_t.n += 1
        return tuple(torch.from_numpy(o) for o in outs[forward_t.n - 1])

    def forward_j(params, images):
        forward_j.n += 1
        return tuple(jnp.asarray(o) for o in outs[forward_j.n - 1])

    forward_t.n = forward_j.n = 0
    got, want = [], []
    monkeypatch.setattr(tinst, "COCOMeanAP", _Recorder(tinst.COCOMeanAP, got))
    monkeypatch.setattr(jinst, "COCOMeanAP", _Recorder(jinst.COCOMeanAP,
                                                       want))
    tds = tcoco_ds.COCODataset(str(tmp_path), "val.json", "val",
                               img_size=test_size, preproc=ttr.ValTransform())
    jds = jcoco_ds.COCODataset(str(tmp_path), "val.json", "val",
                               img_size=test_size, preproc=jtr.ValTransform())
    kw = dict(conf_thre=0.3, nms_thre=0.5, num_classes=3, mask_thres=0.3,
              d_rate=d_rate)
    mt = tinst.COCOInstEvaluator(tds, test_size, device="cpu", **kw).evaluate(
        forward_t)
    mj = jinst.COCOInstEvaluator(jds, test_size, **kw).evaluate(forward_j,
                                                                 None)
    (bt, box_t), (st, seg_t) = got
    (bj, box_j), (sj, seg_j) = want
    assert (bt, st) == (bj, sj) == ("bbox", "segm")
    assert box_t == box_j and len(box_t) > 4
    # the masks: equal but where cv2's value is within MASK_BOUND of the
    # threshold; recomputed here from each result's image and detection
    r = min(test_size[0] / hw[0], test_size[1] / hw[1])
    near = differ = 0
    rows = [(i, k) for i, (dets, valid, _) in enumerate(outs)
            for k in np.flatnonzero(valid) if dets[k, 6] < 2]
    assert len(rows) == len(seg_t) == len(seg_j)
    for (i, k), a, b in zip(rows, seg_t, seg_j):
        assert {x: a[x] for x in a if x != "segmentation"} == \
            {x: b[x] for x in b if x != "segmentation"}
        m = outs[i][2][k]
        ch = int(round(hw[0] * r * m.shape[0] / test_size[0]))
        cw = int(round(hw[1] * r * m.shape[1] / test_size[1]))
        ref = cv2.resize(np.ascontiguousarray(m[:ch, :cw]), (hw[1], hw[0]),
                         interpolation=cv2.INTER_LINEAR)
        close = np.abs(ref - kw["mask_thres"]) <= MASK_BOUND
        dt, dj = trle.decode(a["segmentation"]), trle.decode(
            b["segmentation"])
        assert not (dt != dj)[~close].any()
        near += int(close.sum())
        differ += int((dt != dj).sum())
    print(f"inst masks: {differ} pixels differ from JAX's, {near} pixels "
          f"within {MASK_BOUND} of mask_thres")
    mt.pop("infer_time_s"), mj.pop("infer_time_s")
    if differ == 0:
        assert mt == mj
    else:
        assert {k: v for k, v in mt.items() if k.startswith("box")} == \
            {k: v for k, v in mj.items() if k.startswith("box")}
    assert "mask_AP" in mt and mt["n_images"] == 2


def test_unletterbox_mask_threshold_bound():
    """resize_linear against cv2.INTER_LINEAR on float32 masks of the
    shapes the inst path makes: the binary masks differ only where cv2's
    value is within MASK_BOUND of the threshold."""
    rng = np.random.RandomState(2)
    for (hm, wm), (h, w) in [((16, 16), (60, 90)), ((200, 320), (720, 1280)),
                             ((25, 40), (99, 161))]:
        m = rng.rand(hm, wm).astype(np.float32)
        got = tpre.resize_linear(m, (w, h))
        ref = cv2.resize(m, (w, h), interpolation=cv2.INTER_LINEAR)
        assert np.abs(got - ref).max() <= MASK_BOUND
        for thr in (0.3, 0.5):
            diff = (got > thr) != (ref > thr)
            close = np.abs(ref - thr) <= MASK_BOUND
            assert not diff[~close].any()
            print(f"{hm}x{wm} -> {h}x{w} at {thr}: {int(diff.sum())} of "
                  f"{int(close.sum())} pixels within {MASK_BOUND} differ")


# -------------------------------------------------------------------- VOC
def _write_voc(root, n=3):
    base = os.path.join(root, "VOC2007")
    for d in ("Annotations", "JPEGImages", os.path.join("ImageSets", "Main")):
        os.makedirs(os.path.join(base, d))
    rng = np.random.RandomState(3)
    names = ["dog", "cat", "car", "person"]
    for i in range(n):
        xml = ("<annotation><size><width>100</width><height>80</height>"
               "<depth>3</depth></size>")
        for _ in range(3):
            x, y = rng.randint(0, 50), rng.randint(0, 40)
            xml += (f"<object><name>{names[rng.randint(0, 4)]}</name>"
                    f"<difficult>{int(rng.rand() < 0.2)}</difficult><bndbox>"
                    f"<xmin>{x}</xmin><ymin>{y}</ymin><xmax>{x + 30}</xmax>"
                    f"<ymax>{y + 25}</ymax></bndbox></object>")
        with open(os.path.join(base, "Annotations", f"{i:06d}.xml"),
                  "w") as f:
            f.write(xml + "</annotation>")
        cv2.imwrite(os.path.join(base, "JPEGImages", f"{i:06d}.jpg"),
                    (rng.rand(80, 100, 3) * 255).astype(np.uint8))
    with open(os.path.join(base, "ImageSets", "Main", "test.txt"), "w") as f:
        f.write("".join(f"{i:06d}\n" for i in range(n)))


@pytest.mark.parametrize("use_07", [False, True])
def test_voc_evaluator_matches_jax(tmp_path, use_07):
    _write_voc(str(tmp_path))
    rng = np.random.RandomState(4)
    outs = []
    for _ in range(3):
        d = np.zeros((6, 7), np.float32)
        xy = rng.uniform(0, 40, (6, 2))
        d[:, :4] = np.concatenate([xy, xy + rng.uniform(10, 30, (6, 2))], 1)
        d[:, 4:6] = rng.uniform(0, 1, (6, 2))
        d[:, 6] = rng.choice([7, 11, 14, 19], 6)   # car, dog, person, tv
        outs.append(d)
    calls = {"t": 0, "j": 0}

    def det_t(img):
        calls["t"] += 1
        assert img.shape == (1, 3, 64, 96)
        return torch.from_numpy(outs[calls["t"] - 1])

    def det_j(img):
        calls["j"] += 1
        return outs[calls["j"] - 1]

    kw = dict(img_size=(64, 96), conf_thre=0.05, use_07_metric=use_07)
    tds = tvoc_ds.VOCDetection(str(tmp_path), image_sets=(("2007", "test"),),
                               img_size=(64, 96))
    jds = jvoc_ds.VOCDetection(str(tmp_path), image_sets=(("2007", "test"),),
                               img_size=(64, 96))
    got = tvoc.VOCEvaluator(tds, device="cpu", **kw).evaluate(det_t)
    assert got == jvoc.VOCEvaluator(jds, **kw).evaluate(det_j)
    assert got["per_class"]


# -------------------------------------------------------------------- MOT
def _mot_outputs(ds, seed, n_slots=10):
    """Per frame of mot_cases.FakeMOTDataset: (dets (n_slots, 7), valid)
    in letterbox coordinates (jittered gt, a miss, clutter, two classes)
    and an embedding table."""
    rng = np.random.RandomState(seed)
    r = min(ds.img_size[0] / ds.hw[0], ds.img_size[1] / ds.hw[1])
    outs = []
    for _, _, boxes in ds.items:
        dets = np.zeros((n_slots, 7), np.float32)
        keep = [b for b in boxes if rng.rand() > 0.1]
        keep += [np.r_[rng.uniform(0, 30, 2), 0, 0] + [0, 0, 9, 11]
                 for _ in range(rng.randint(0, 2))]
        n = len(keep)
        dets[:n, :4] = (np.asarray(keep) + rng.normal(0, 0.3, (n, 4))) * r
        dets[:n, 4] = rng.uniform(0.5, 1, n)
        dets[:n, 5] = rng.uniform(0.8, 1, n)
        dets[:n, 6] = rng.randint(0, 2, n)
        valid = np.zeros(n_slots, bool)
        valid[:n] = True
        outs.append((dets, valid))
    return outs


def _embed(centers):
    c = np.asarray(centers, np.float64)
    ang = c @ np.array([[0.05, 0.21], [0.17, 0.03]])
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=1) * 4


@pytest.mark.parametrize("tracker", ["byte", "sort"])
def test_mot_evaluate_matches_jax(tmp_path, tracker):
    ds = mot_cases.FakeMOTDataset()
    outs = _mot_outputs(ds, 1)
    n = {"t": 0, "j": 0}

    def step_t(frame):
        n["t"] += 1
        return tuple(torch.from_numpy(o) for o in outs[n["t"] - 1])

    def step_j(params, frame):
        n["j"] += 1
        return tuple(jnp.asarray(o) for o in outs[n["j"] - 1])

    kw = dict(dataset=ds, track_thresh=0.5, min_box_area=1)
    got = tmot.MOTEvaluator(device="cpu", **kw).evaluate(
        step_t, result_dir=str(tmp_path / "t"), tracker=tracker)
    want = jmot.MOTEvaluator(**kw).evaluate(
        step_j, None, result_dir=str(tmp_path / "j"), tracker=tracker)
    assert got == want and sum(len(f[1]) for f in got["vid0"]) > 3
    for v in ("vid0", "vid1"):
        assert open(tmp_path / "t" / f"{v}.txt").read() == \
            open(tmp_path / "j" / f"{v}.txt").read()
    assert tmot.MOTEvaluator.score(got, ds.gt) == \
        jmot.MOTEvaluator.score(want, ds.gt)


@pytest.mark.parametrize("tracker", ["qd", "deepsort", "motdt"])
def test_mot_evaluate_omni_matches_jax(tracker):
    ds = mot_cases.FakeMOTDataset()
    outs = _mot_outputs(ds, 2)
    n = {"t": 0, "j": 0}
    feat = np.zeros((1, 4, 4, 8), np.float32)

    def whole_t(frame):
        n["t"] += 1
        d, v = outs[n["t"] - 1]
        return torch.from_numpy(d), torch.from_numpy(v), torch.zeros(1, 8, 4,
                                                                    4)

    def whole_j(params, frame):
        n["j"] += 1
        d, v = outs[n["j"] - 1]
        return jnp.asarray(d), jnp.asarray(v), jnp.asarray(feat)

    kw = dict(dataset=ds, track_thresh=0.5, min_box_area=1)
    qd = dict(init_score_thr=0.6, obj_score_thr=0.3, match_score_thr=0.5)
    got = tmot.MOTEvaluator(device="cpu", **kw).evaluate_omni(
        whole_t, lambda a, b, c: torch.from_numpy(_embed(c)).float(),
        qd_params=qd, tracker=tracker)
    want = jmot.MOTEvaluator(**kw).evaluate_omni(
        whole_j, lambda p, a, b, c: _embed(c).astype(np.float32), None,
        qd_params=qd, tracker=tracker)
    assert got == want and sum(len(f[1]) for f in got["vid1"]) > 3


def test_mot_evaluate_omni_mots_matches_jax(tmp_path):
    ds = mots_cases.FakeMOTSDataset()
    r = min(ds.img_size[0] / ds.hw[0], ds.img_size[1] / ds.hw[1])
    rng = np.random.RandomState(6)
    outs = []
    for _, boxes in ds.items:
        n = len(boxes)
        dets = np.zeros((8, 7), np.float32)
        dets[:n, :4] = boxes * r + rng.normal(0, 0.3, (n, 4))
        dets[:n, 4] = rng.uniform(0.6, 1, n)
        dets[:n, 5] = 1.0
        dets[n, :4] = dets[1, :4] + 0.5          # a near-duplicate
        dets[n, 4:6] = (0.62, 1.0)
        masks = np.zeros((8,) + ds.img_size, np.float32)
        for k in range(n + 1):
            b = np.round(dets[k, :4]).astype(int)
            masks[k, b[1]:b[3], b[0]:b[2]] = rng.uniform(0.4, 1)
        valid = np.arange(8) <= n
        outs.append((dets, valid, masks))
    n = {"t": 0, "j": 0}

    def whole_t(frame):
        n["t"] += 1
        d, v, m = outs[n["t"] - 1]
        return (torch.from_numpy(d), torch.from_numpy(v), torch.zeros(1),
                torch.from_numpy(m).half())

    def whole_j(params, frame):
        n["j"] += 1
        d, v, m = outs[n["j"] - 1]
        return d, v, np.zeros(1), m.astype(np.float16).astype(np.float32)

    qd = dict(init_score_thr=0.6, obj_score_thr=0.3, match_score_thr=0.5)
    got = tmot.MOTEvaluator(dataset=ds, device="cpu").evaluate_omni_mots(
        whole_t, lambda a, b, c: torch.from_numpy(_embed(c)).float(),
        qd_params=qd, result_dir=str(tmp_path / "t"))
    want = jmot.MOTEvaluator(dataset=ds).evaluate_omni_mots(
        whole_j, lambda p, a, b, c: _embed(c).astype(np.float32), None,
        qd_params=qd, result_dir=str(tmp_path / "j"))
    assert got == want and sum(len(f[1]) for f in got["vid0"]) >= 16
    assert open(tmp_path / "t" / "vid0.txt").read() == \
        open(tmp_path / "j" / "vid0.txt").read()
    assert tmot.MOTEvaluator.score_mots(got, ds.gt) == \
        jmot.MOTEvaluator.score_mots(want, ds.gt)


# -------------------------------------------------------------------- BDD
class _StubSegDriver:
    """A with_mask MOTOmniDriver stand-in: seeded tracks and mask scores on
    the letterbox grid, the same for both packages."""

    def __init__(self, input_size, r, seed):
        self.input_size, self.last_scale = input_size, r
        self.rng = np.random.RandomState(seed)
        self.with_mask = True

    def reset(self):
        pass

    def update(self, img):
        rng = self.rng
        n = rng.randint(0, 4)
        xy = rng.uniform(0, 50, (n, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(8, 30, (n, 2)),
                                rng.uniform(0.3, 1, (n, 1))], 1)
        ids = rng.permutation(6)[:n] + 1
        labels = rng.randint(0, 9, n)        # 8: outside BDD_CLASSES
        masks = rng.uniform(0, 1, (n,) + self.input_size).astype(np.float32)
        return boxes, labels, ids, masks


def test_bdd_evaluator_matches_jax(tmp_path):
    root = bdd_cases._make_fixture(str(tmp_path / "data"), with_mots=True)
    label_path = os.path.join(root, "labels", "seg_track_20", "rles",
                              "val.json")
    tds = tbdd_ds.BDDEvalDataset(root, split="val", label_path=label_path,
                                 img_size=(48, 64),
                                 preproc=ttr.ValTransform())
    jds = jbdd_ds.BDDEvalDataset(root, split="val", label_path=label_path,
                                 img_size=(48, 64),
                                 preproc=jtr.ValTransform())
    size = (48, 64)
    te = tbdd.BDDEvaluator(tds, size, device="cpu")
    je = jbdd.BDDEvaluator(jds, size)
    # evaluate_det on a seeded step function
    rng = np.random.RandomState(8)
    outs = [((rng.uniform(0, 40, (5, 7))
              * [1, 1, 1.5, 1.2, 0.02, 0.02, 0.25]).astype(np.float32),
             rng.rand(5) < 0.8) for _ in range(len(tds))]
    n = {"t": 0, "j": 0}

    def step_t(frame):
        n["t"] += 1
        return tuple(torch.from_numpy(o) for o in outs[n["t"] - 1])

    def step_j(params, frame):
        n["j"] += 1
        return tuple(jnp.asarray(o) for o in outs[n["j"] - 1])

    got = te.evaluate_det(step_t, out_path=str(tmp_path / "t" / "det.json"))
    assert got == je.evaluate_det(step_j, None,
                                  out_path=str(tmp_path / "j" / "det.json"))
    assert open(tmp_path / "t" / "det.json").read() == \
        open(tmp_path / "j" / "det.json").read()
    # evaluate_mot, evaluate_seg_mot on the same stub driver
    drv = bdd_cases._PerfectDriver
    rt, ft = te.evaluate_mot(drv(tds), out_dir=str(tmp_path / "t"))
    rj, fj = je.evaluate_mot(drv(jds), out_dir=str(tmp_path / "j"))
    assert (rt, ft) == (rj, fj)
    assert tbdd.score_scalabel(ft, tds.gt_frames()) == \
        jbdd.score_scalabel(fj, jds.gt_frames())
    r = min(size[0] / bdd_cases.H, size[1] / bdd_cases.W)
    rt, ft = te.evaluate_seg_mot(_StubSegDriver(size, r, 9),
                                 out_dir=str(tmp_path / "t"))
    rj, fj = je.evaluate_seg_mot(_StubSegDriver(size, r, 9),
                                 out_dir=str(tmp_path / "j"))
    assert (rt, ft) == (rj, fj)
    for name in ("track.json", "seg_track.json"):
        assert open(tmp_path / "t" / name).read() == \
            open(tmp_path / "j" / name).read()
    n_png = 0
    for video in ("vid_a", "vid_b"):
        d = tmp_path / "t" / "seg_track" / video
        for f in sorted(os.listdir(d)):
            mine = image_io.read_png(str(d / f))
            theirs = np.asarray(Image.open(tmp_path / "j" / "seg_track"
                                           / video / f))
            assert mine.shape == (bdd_cases.H, bdd_cases.W, 4) or \
                mine.shape == (1, 1, 4)
            np.testing.assert_array_equal(mine, theirs)
            np.testing.assert_array_equal(np.asarray(Image.open(d / f)),
                                          theirs)
            n_png += 1
    assert n_png == len(tds)


# ------------------------------------------------------ host helpers
def test_resize_nearest_equals_cv2():
    """Shrink and grow factors, odd sizes, 1-pixel crops, 1 and 3
    channels, uint8 and float32."""
    rng = np.random.RandomState(0)
    n = 0
    for sh in (1, 2, 3, 7, 17, 64, 99, 333):
        for sw in (1, 5, 321):
            ch = () if (sh + sw) % 2 else (3,)
            img = rng.randint(0, 256, (sh, sw) + ch).astype(np.uint8)
            for dh in (1, 2, 15, 100, 720):
                for dw in (1, 3, 127, 1280):
                    ref = cv2.resize(img, (dw, dh),
                                     interpolation=cv2.INTER_NEAREST)
                    np.testing.assert_array_equal(
                        tpre.resize_nearest(img, (dw, dh)), ref)
                    n += 1
    f = rng.rand(37, 53).astype(np.float32)
    np.testing.assert_array_equal(
        tpre.resize_nearest(f, (90, 61)),
        cv2.resize(f, (90, 61), interpolation=cv2.INTER_NEAREST))
    assert n == 8 * 3 * 5 * 4


@pytest.mark.parametrize("shape", [(1, 1), (13, 7), (9, 31, 3), (40, 54, 4)])
def test_write_png_round_trips(tmp_path, shape):
    a = np.random.RandomState(len(shape)).randint(0, 256, shape).astype(
        np.uint8)
    path = str(tmp_path / "sub" / "x.png")
    image_io.write_png(path, a)
    np.testing.assert_array_equal(image_io.read_png(path), a)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), a)
    bgr = image_io.imread(path)
    np.testing.assert_array_equal(bgr, cv2.imread(path))
    if a.ndim == 3:
        np.testing.assert_array_equal(bgr, a[..., 2::-1])
    with pytest.raises(ValueError):
        image_io.write_png(path, a.astype(np.float32))


# ---------------------------------- the JAX package's cases, re-run
@pytest.mark.parametrize("case", ["test_perfect_predictions_ap1",
                                  "test_shifted_predictions_lower_ap"])
def test_jax_coco_evaluator_cases_on_the_port(case, monkeypatch, tmp_path):
    monkeypatch.setattr(coco_cases, "COCODataset", tcoco_ds.COCODataset)
    monkeypatch.setattr(coco_cases, "ValTransform", ttr.ValTransform)
    monkeypatch.setattr(coco_cases, "COCOEvaluator", PortCOCO)
    getattr(coco_cases, case)(tmp_path)


def test_jax_inst_evaluator_case_on_the_port(monkeypatch, tmp_path):
    monkeypatch.setattr(inst_cases, "COCODataset", tcoco_ds.COCODataset)
    monkeypatch.setattr(inst_cases, "ValTransform", ttr.ValTransform)
    monkeypatch.setattr(inst_cases, "rle", trle)
    monkeypatch.setattr(inst_cases, "COCOInstEvaluator", PortInst)
    inst_cases.test_inst_evaluator_perfect(tmp_path)


def test_jax_voc_case_on_the_port(monkeypatch, tmp_path):
    monkeypatch.setattr(jvoc_ds, "VOCDetection", tvoc_ds.VOCDetection)
    monkeypatch.setattr(jvoc, "VOCEvaluator", PortVOC)
    eval_cases.test_voc_evaluator_perfect_detections(tmp_path)


def test_jax_mot_evaluator_case_on_the_port(monkeypatch, tmp_path):
    monkeypatch.setattr(mot_cases, "MOTEvaluator", PortMOT)
    mot_cases.test_mot_evaluate_perfect_tracks(tmp_path)


def test_jax_omni_mots_case_on_the_port(monkeypatch, tmp_path):
    from test_torch_port_eval_metrics import patch_mots_cases

    patch_mots_cases(monkeypatch)
    monkeypatch.setattr(mots_cases, "MOTEvaluator", PortMOT)
    mots_cases.test_evaluate_omni_mots_scores_masks(tmp_path)


@pytest.mark.parametrize("case,kw", [
    ("test_mot_evaluator_sort_path", {}),
    ("test_mot_evaluator_embedding_paths", {"tracker": "deepsort"}),
    ("test_mot_evaluator_embedding_paths", {"tracker": "motdt"})])
def test_jax_legacy_evaluator_cases_on_the_port(case, kw, monkeypatch,
                                                tmp_path):
    monkeypatch.setattr(jmot, "MOTEvaluator", PortMOT)
    getattr(legacy_cases, case)(tmp_path=tmp_path, **kw)


def _patch_bdd_cases(monkeypatch):
    for name in ("BDD_CLASSES", "BDDEvalDataset", "BDDOmniMOTSDataset",
                 "load_scalabel", "parse_labels"):
        monkeypatch.setattr(bdd_cases, name, getattr(tbdd_ds, name))
    monkeypatch.setattr(bdd_cases, "rle_codec", trle)
    monkeypatch.setattr(bdd_cases, "BDDEvaluator", PortBDD)
    monkeypatch.setattr(bdd_cases, "score_scalabel", tbdd.score_scalabel)
    monkeypatch.setattr(jbdd, "score_scalabel_seg", tbdd.score_scalabel_seg)


@pytest.mark.parametrize("case,mots", [
    ("test_bdd_evaluator_e2e_mmota", False),
    ("test_bdd_evaluator_seg_track_e2e", True),
    ("test_bdd_mots_missing_rle_instances_dropped", True)])
def test_jax_bdd_cases_on_the_port(case, mots, monkeypatch, tmp_path):
    _patch_bdd_cases(monkeypatch)
    root = bdd_cases._make_fixture(str(tmp_path / "data"), with_mots=mots)
    fn = getattr(bdd_cases, case)
    if "tmp_path" in fn.__code__.co_varnames[:fn.__code__.co_argcount]:
        fn(root, tmp_path)
    else:
        fn(root)


def test_jax_bdd_seg_mot_stub_case_on_the_port(monkeypatch, tmp_path):
    """tests/test_mots.py's driver-level BDD MOTS loop."""
    from test_torch_port_eval_metrics import patch_mots_cases

    patch_mots_cases(monkeypatch)
    monkeypatch.setattr(jbdd, "BDDEvaluator", PortBDD)
    mots_cases.test_bdd_evaluate_seg_mot_e2e(tmp_path)
