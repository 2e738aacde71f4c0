"""The port's on-disk datasets and the exps' data mixes (unicorn_torch/
data/datasets/{coco,sot,mot,vos,bdd,voc}.py, exp/{track,track_mask,
det_mask}.py) against the JAX package's, on the CPU, over one tree of
tiny datasets in their reference layouts (JPEG frames written by cv2,
palette / gray PNG masks, COCO polygons and RLE, scalabel json, VOC xml).

JAX's datasets draw from the process-global `random` (seeded here with
random.seed(s)); the port's take `rng=random.Random(s)`. Every item
(images, boxes, classes, track ids, masks) is held to equality, and the
generators must end in the same state (the same draws, in the same
order). The exps' group specs (names, weights) equal JAX's under the same
UNICORN_DATADIR; their loaders, one worker, give batches equal to JAX's
after seed_everything(s): images (the HSV jitter's included), task ids,
labels and masks, every value.
"""
import json
import os
import random
import xml.etree.ElementTree as ET

import cv2
import numpy as np
import pytest
import torch

from unicorn_torch.data import loader as tl
from unicorn_torch.data.datasets import bdd as tbdd
from unicorn_torch.data.datasets import coco as tcoco
from unicorn_torch.data.datasets import mot as tmot
from unicorn_torch.data.datasets import sot as tsot
from unicorn_torch.data.datasets import voc as tvoc
from unicorn_torch.data.datasets import vos as tvos
from unicorn_torch.evaluators import rle as trle
from unicorn_tpu.data import loader as jl
from unicorn_tpu.data.datasets import bdd as jbdd
from unicorn_tpu.data.datasets import coco as jcoco
from unicorn_tpu.data.datasets import mot as jmot
from unicorn_tpu.data.datasets import sot as jsot
from unicorn_tpu.data.datasets import voc as jvoc
from unicorn_tpu.data.datasets import vos as jvos
from unicorn_tpu.evaluators import rle as jrle


def _frame(h, w, seed):
    r = np.random.RandomState(seed)
    a = r.randint(0, 256, (h, w, 3)).astype(np.uint8)
    return cv2.GaussianBlur(a, (5, 5), 1.2)


def _jpg(path, h, w, seed):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    cv2.imwrite(path, _frame(h, w, seed), [cv2.IMWRITE_JPEG_QUALITY, 85])


def _json(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


def _palette_png(path, ids):
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    m = Image.fromarray(ids.astype(np.uint8), "P")
    m.putpalette([0, 0, 0, 128, 0, 0, 0, 128, 0, 128, 128, 0] + [9] * 756)
    m.save(path)


def _blob_ids(h, w, t, n):
    ids = np.zeros((h, w), np.uint8)
    for k in range(1, n + 1):
        y, x = 3 + 2 * t + 9 * (k - 1), 4 + 3 * t + 11 * (k - 1)
        ids[y:y + 8, x:x + 10] = k
    return ids


def _coco(root, rng):
    """3 images with polygons (vertices on the border included), RLE
    masks, a crowd box and one image without annotations."""
    imgs, anns, aid = [], [], 1
    for i, (h, w) in enumerate([(40, 56), (33, 47), (48, 64), (24, 30)]):
        name = f"{i:012d}.jpg"
        _jpg(os.path.join(root, "coco", "train2017", name), h, w, 10 + i)
        imgs.append({"id": 100 + i, "file_name": name, "width": w,
                     "height": h})
        if i == 3:
            continue
        for k in range(3):
            x0, y0 = rng.uniform(0, w * 0.6), rng.uniform(0, h * 0.6)
            bw, bh = rng.uniform(4, w - x0), rng.uniform(4, h - y0)
            a = {"id": aid, "image_id": 100 + i, "category_id": [1, 3, 7][k],
                 "bbox": [x0, y0, bw, bh], "area": bw * bh, "iscrowd": 0}
            if k == 1:
                m = np.zeros((h, w), np.uint8)
                m[int(y0):int(y0 + bh), int(x0):int(x0 + bw)] = 1
                a["segmentation"] = jrle.encode(m)
            else:
                poly = [x0, y0, x0 + bw, y0, x0 + bw * 0.7, y0 + bh,
                        float(w), float(h), x0, y0 + bh * 0.5]
                a["segmentation"] = [poly, [1.0, 1.0, 9.5, 2.0, 4.0, 8.0]]
            anns.append(a)
            aid += 1
        anns.append({"id": aid, "image_id": 100 + i, "category_id": 1,
                     "bbox": [1, 1, 5, 5], "area": 25, "iscrowd": 1,
                     "segmentation": [[1, 1, 6, 1, 6, 6]]})
        aid += 1
    _json(os.path.join(root, "coco", "annotations",
                       "instances_train2017.json"),
          {"images": imgs, "annotations": anns,
           "categories": [{"id": c, "name": f"c{c}"} for c in (1, 3, 7)]})


def _sot(root, rng):
    for cls in ("cat", "dog"):
        seq = os.path.join(root, "LaSOT", cls, f"{cls}-1")
        n = 9
        for t in range(n):
            _jpg(os.path.join(seq, "img", f"{t + 1:08d}.jpg"), 30, 44, t)
        gt = np.c_[rng.uniform(0, 20, (n, 2)), rng.uniform(0, 16, (n, 2))]
        gt[2, 2] = 0  # an empty box: not visible
        np.savetxt(os.path.join(seq, "groundtruth.txt"), gt, fmt="%.2f",
                   delimiter=",")
        np.savetxt(os.path.join(seq, "full_occlusion.txt"),
                   [[int(t in (4, 5)) for t in range(n)]], fmt="%d",
                   delimiter=",")
        np.savetxt(os.path.join(seq, "out_of_view.txt"),
                   [[int(t == 7) for t in range(n)]], fmt="%d", delimiter=",")
    base = os.path.join(root, "GOT10K", "train")
    for s in range(2):
        seq = os.path.join(base, f"GOT-10k_Train_{s + 1:06d}")
        for t in range(6):
            _jpg(os.path.join(seq, f"{t + 1:08d}.jpg"), 26, 34, 50 + t)
        np.savetxt(os.path.join(seq, "groundtruth.txt"),
                   np.c_[rng.uniform(0, 10, (6, 2)), rng.uniform(2, 12, (6, 2))],
                   fmt="%.3f", delimiter=",")
        np.savetxt(os.path.join(seq, "absence.label"), [0, 1, 0, 0, 0, 0],
                   fmt="%d")
    with open(os.path.join(base, "list.txt"), "w") as f:
        f.write("GOT-10k_Train_000002\nGOT-10k_Train_000001\n")
    chunk = os.path.join(root, "TrackingNet", "TRAIN_0")
    for name in ("a_seq", "b_seq"):
        for t in range(5):
            _jpg(os.path.join(chunk, "frames", name, f"{t}.jpg"), 20, 28, t)
        os.makedirs(os.path.join(chunk, "anno"), exist_ok=True)
        np.savetxt(os.path.join(chunk, "anno", name + ".txt"),
                   np.c_[rng.uniform(0, 8, (5, 2)), rng.uniform(2, 9, (5, 2))],
                   fmt="%.2f", delimiter=",")


def _mot(root, rng):
    imgs, anns, aid = [], [], 1
    for v in range(2):
        for fid in range(1, 6):
            iid = 10 * v + fid
            name = f"v{v}/{fid:06d}.jpg"
            _jpg(os.path.join(root, "mot", "train", name), 32, 48, iid)
            imgs.append({"id": iid, "file_name": name, "width": 48,
                         "height": 32, "video_id": v + 1,
                         "frame_id": fid * (1 + v)})
            for k in range(3):
                anns.append({"id": aid, "image_id": iid, "category_id": 1,
                             "bbox": [float(x) for x in rng.uniform(
                                 0, 20, 4)], "track_id": k + 1,
                             "iscrowd": int(k == 2 and fid == 3)})
                aid += 1
    name = "static.jpg"
    _jpg(os.path.join(root, "mot", "train", name), 32, 48, 99)
    imgs.append({"id": 99, "file_name": name, "width": 48, "height": 32})
    anns.append({"id": aid, "image_id": 99, "category_id": 1,
                 "bbox": [2, 2, 10, 10]})
    _json(os.path.join(root, "mot", "annotations", "train_omni.json"),
          {"images": imgs, "annotations": anns,
           "categories": [{"id": 1, "name": "pedestrian"}]})


def _bdd(root, rng):
    for split in ("train",):
        box_frames, seg_frames = [], []
        for video in ("vid_a", "vid_b"):
            for t in range(5):
                name = f"{video}-{t + 1:07d}.jpg"
                _jpg(os.path.join(root, "bdd100k", "images", "track", split,
                                  video, name), 36, 52, t + len(video))
                labs, segs = [], []
                for k, cat in enumerate(("car", "pedestrian", "trailer",
                                         "bus")):
                    x1, y1 = rng.uniform(0, 30), rng.uniform(0, 20)
                    box = {"x1": x1, "y1": y1, "x2": x1 + 12, "y2": y1 + 10}
                    lab = {"id": str(k + 1), "category": cat, "box2d": box}
                    if k == 3 and t == 2:
                        lab["attributes"] = {"crowd": True}
                    labs.append(lab)
                    m = np.zeros((36, 52), np.uint8)
                    m[int(y1):int(y1) + 10, int(x1):int(x1) + 12] = 1
                    seg = {"id": str(k + 1), "category": cat,
                           "rle": jrle.encode(m)}
                    if k != 1:
                        seg["box2d"] = box
                    if k == 0 and t == 3:
                        seg.pop("rle")  # a box without its rle
                    segs.append(seg)
                box_frames.append({"name": name, "videoName": video,
                                   "frameIndex": t, "labels": labs})
                seg_frames.append({"name": name, "videoName": video,
                                   "frameIndex": t, "labels": segs})
        _json(os.path.join(root, "bdd100k", "labels", "box_track_20",
                           f"{split}.json"), box_frames)
        _json(os.path.join(root, "bdd100k", "labels", "seg_track_20", "rles",
                           f"{split}.json"), seg_frames)


def _vos(root, rng):
    for seq in ("bear", "cows"):
        for t in range(5):
            _jpg(os.path.join(root, "DAVIS", "JPEGImages", "480p", seq,
                              f"{t:05d}.jpg"), 30, 42, t)
            _palette_png(os.path.join(root, "DAVIS", "Annotations", "480p",
                                      seq, f"{t:05d}.png"),
                         _blob_ids(30, 42, t, 2 + (seq == "cows")))
    os.makedirs(os.path.join(root, "DAVIS", "ImageSets", "2017"))
    with open(os.path.join(root, "DAVIS", "ImageSets", "2017", "train.txt"),
              "w") as f:
        f.write("bear\ncows\n")
    for seq in ("v1", "v2"):
        for t in range(4):
            base = os.path.join(root, "ytbvos18", "train")
            _jpg(os.path.join(base, "JPEGImages", seq, f"{5 * t:05d}.jpg"),
                 28, 40, 20 + t)
            _palette_png(os.path.join(base, "Annotations", seq,
                                      f"{5 * t:05d}.png"),
                         _blob_ids(28, 40, t, 1 + (seq == "v2")))
    for k in range(2):
        _jpg(os.path.join(root, "saliency", "image", f"s{k}.jpg"), 26, 38, k)
        m = np.zeros((26, 38), np.uint8)
        m[4 + k:18, 6:30 - k] = 200
        m[5, 7] = 100  # below the 127 cut
        os.makedirs(os.path.join(root, "saliency", "mask"), exist_ok=True)
        cv2.imwrite(os.path.join(root, "saliency", "mask", f"s{k}.png"), m)
    imgs, anns, aid = [], [], 1
    for v in range(2):
        for fid in (1, 2, 4, 40):
            iid = 100 * v + fid
            name = f"train/{v:04d}/{fid:06d}.jpg"
            _jpg(os.path.join(root, "MOTS", name), 30, 40, iid)
            imgs.append({"id": iid, "file_name": name, "width": 40,
                         "height": 30, "video_id": v, "frame_id": fid})
            if fid == 4 and v == 1:
                continue  # an empty frame
            for k in range(2):
                m = np.zeros((30, 40), np.uint8)
                m[3 + 5 * k:12 + 5 * k, 4 + fid % 7:20] = 1
                anns.append({"id": aid, "image_id": iid, "category_id": 1,
                             "bbox": [4, 3, 16, 9], "track_id": 10 * v + k,
                             "segmentation": jrle.encode(m), "iscrowd": 0})
                aid += 1
    _json(os.path.join(root, "MOTS", "annotations", "train_mots.json"),
          {"images": imgs, "annotations": anns,
           "categories": [{"id": 1, "name": "pedestrian"}]})


def _voc(root, rng):
    base = os.path.join(root, "VOCdevkit", "VOC2007")
    ids = ["000001", "000002"]
    for i, iid in enumerate(ids):
        _jpg(os.path.join(base, "JPEGImages", iid + ".jpg"), 30, 40, i)
        ann = ET.Element("annotation")
        size = ET.SubElement(ann, "size")
        ET.SubElement(size, "width").text = "40"
        ET.SubElement(size, "height").text = "30"
        for k, name in enumerate(("cat", "dog", "unicorn")):
            obj = ET.SubElement(ann, "object")
            ET.SubElement(obj, "name").text = name
            ET.SubElement(obj, "difficult").text = str(int(k == 1))
            bb = ET.SubElement(obj, "bndbox")
            for tag, v in zip(("xmin", "ymin", "xmax", "ymax"),
                              (2 + k, 3, 20 + k, 25)):
                ET.SubElement(bb, tag).text = str(v)
        os.makedirs(os.path.join(base, "Annotations"), exist_ok=True)
        ET.ElementTree(ann).write(os.path.join(base, "Annotations",
                                               iid + ".xml"))
    os.makedirs(os.path.join(base, "ImageSets", "Main"))
    with open(os.path.join(base, "ImageSets", "Main", "trainval.txt"),
              "w") as f:
        f.write("\n".join(ids) + "\n")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(1)
    r = str(tmp_path_factory.mktemp("datasets"))
    rng = np.random.RandomState(0)
    for write in (_coco, _sot, _mot, _bdd, _vos, _voc):
        write(r, rng)
    return r


def _same(a, b, what):
    if isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and \
            a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
        assert np.array_equal(a, b), what
    else:
        assert a == b, (what, a, b)


def _datasets(root, which):
    """(JAX dataset, port dataset) built the same way."""
    p = lambda *a: os.path.join(root, *a)  # noqa: E731
    if which == "lasot":
        return jsot.Lasot(p("LaSOT"), max_gap=3), \
            tsot.Lasot(p("LaSOT"), max_gap=3)
    if which == "got10k":
        return jsot.Got10k(p("GOT10K", "train"), max_gap=2), \
            tsot.Got10k(p("GOT10K", "train"), max_gap=2)
    if which == "trackingnet":
        return jsot.TrackingNet(p("TrackingNet"), max_gap=1), \
            tsot.TrackingNet(p("TrackingNet"), max_gap=1)
    if which == "cocosot":
        return jsot.COCOSOT(jcoco.COCODataset(p("coco"))), \
            tsot.COCOSOT(tcoco.COCODataset(p("coco")))
    if which == "mot":
        return jmot.MOTOmniDataset(p("mot"), "train_omni.json", max_gap=2), \
            tmot.MOTOmniDataset(p("mot"), "train_omni.json", max_gap=2)
    if which == "bdd":
        return jbdd.BDDOmniDataset(p("bdd100k")), \
            tbdd.BDDOmniDataset(p("bdd100k"))
    if which == "bdd_mots":
        return jbdd.BDDOmniMOTSDataset(p("bdd100k")), \
            tbdd.BDDOmniMOTSDataset(p("bdd100k"))
    if which == "davis":
        return jvos.DAVISTrainDataset(p("DAVIS"), max_gap=2), \
            tvos.DAVISTrainDataset(p("DAVIS"), max_gap=2)
    if which == "ytvos":
        return jvos.YoutubeVOSDataset(p("ytbvos18"), max_gap=1), \
            tvos.YoutubeVOSDataset(p("ytbvos18"), max_gap=1)
    if which == "saliency":
        return jvos.SaliencyDataset(p("saliency")), \
            tvos.SaliencyDataset(p("saliency"))
    if which == "coco_mots":
        return jvos.COCOMOTSDataset(p("coco")), \
            tvos.COCOMOTSDataset(p("coco"))
    if which == "coco_person":
        return jvos.COCOMOTSDataset(p("coco"), person_only=True), \
            tvos.COCOMOTSDataset(p("coco"), person_only=True)
    if which == "mots":
        return jvos.MOTSVideoDataset(p("MOTS"), max_gap=2), \
            tvos.MOTSVideoDataset(p("MOTS"), max_gap=2)
    raise KeyError(which)


OMNI = ["lasot", "got10k", "trackingnet", "cocosot", "mot", "bdd",
        "bdd_mots", "davis", "ytvos", "saliency", "coco_mots", "coco_person",
        "mots"]


@pytest.mark.parametrize("which", OMNI)
def test_pull_item_omni_matches_jax(root, which):
    jds, tds = _datasets(root, which)
    assert len(jds) == len(tds) > 0
    for seed in range(3):
        for seq in range(len(jds)):
            for n in (1, 2):
                random.seed(seed * 100 + seq)
                ref = jds.pull_item_omni(seq, n)
                rng = random.Random(seed * 100 + seq)
                got = tds.pull_item_omni(seq, n, rng=rng)
                _same([list(f) for f in got], [list(f) for f in ref],
                      f"{which} seq {seq} seed {seed}")
                assert rng.random() == random.random(), (which, "draws")
    if which in ("coco_mots", "davis", "bdd_mots"):  # masks were exercised
        assert any(f[2].sum() for f in got)


@pytest.mark.parametrize("which", ["coco", "mot_eval", "bdd_eval", "voc"])
def test_pull_item_matches_jax(root, which):
    p = lambda *a: os.path.join(root, *a)  # noqa: E731
    if which == "coco":
        jds, tds = jcoco.COCODataset(p("coco")), tcoco.COCODataset(p("coco"))
    elif which == "mot_eval":
        jds = jmot.MOTEvalDataset(p("mot"), "train_omni.json", "train")
        tds = tmot.MOTEvalDataset(p("mot"), "train_omni.json", "train")
    elif which == "bdd_eval":
        jds = jbdd.BDDEvalDataset(p("bdd100k"), "train")
        tds = tbdd.BDDEvalDataset(p("bdd100k"), "train")
        assert tds.gt_frames() == jds.gt_frames()
    else:
        sets = (("2007", "trainval"),)
        jds = jvoc.VOCDetection(p("VOCdevkit"), sets, keep_difficult=False)
        tds = tvoc.VOCDetection(p("VOCdevkit"), sets, keep_difficult=False)
    assert len(jds) == len(tds) > 0
    for i in range(len(jds)):
        _same(list(tds.pull_item(i)), list(jds.pull_item(i)), f"{which} {i}")


def test_codecs_and_parsers_match_jax(root):
    """RLE round trips and areas, _boxes_from_masks, scalabel parsing and
    VOC xml against JAX's."""
    rng = np.random.RandomState(3)
    for t in range(40):
        h, w = rng.randint(1, 30, 2)
        m = (rng.rand(h, w) < rng.rand()).astype(np.uint8)
        e = jrle.encode(m)
        assert trle.encode(m) == e and trle.encode_counts(m) == \
            jrle.encode_counts(m)
        _same(trle.decode(e), jrle.decode(e), "decode")
        _same(trle.decode(jrle.encode_counts(m)), m, "decode counts")
        assert trle.area(e) == jrle.area(e) == int(m.sum())
        assert trle.decompress(e) == jrle.decompress(e)
        e2 = jrle.encode((rng.rand(h, w) < 0.5).astype(np.uint8))
        np.testing.assert_allclose(trle.iou_rle([e], [e2, e]),
                                   jrle.iou_rle([e], [e2, e]), rtol=1e-6)
        assert trle.merge([e, e2]) == jrle.merge([e, e2])
    masks = (rng.rand(12, 15, 4) < 0.1).astype(np.uint8)
    masks[..., 2] = 0
    _same(tvos._boxes_from_masks(masks), jvos._boxes_from_masks(masks),
          "boxes")
    labels = os.path.join(root, "bdd100k", "labels")
    for path in (os.path.join(labels, "box_track_20", "train.json"),
                 os.path.join(labels, "seg_track_20", "rles")):
        tv, jv = tbdd.load_scalabel(path), jbdd.load_scalabel(path)
        assert tv == jv
        for frames in jv.values():
            for f in frames:
                for with_rle in (False, True):
                    _same(list(tbdd.parse_labels(f, with_rle)),
                          list(jbdd.parse_labels(f, with_rle)), "labels")
    xml = os.path.join(root, "VOCdevkit", "VOC2007", "Annotations",
                       "000001.xml")
    for keep in (False, True):
        _same(list(tvoc.parse_voc_xml(xml, keep)),
              list(jvoc.parse_voc_xml(xml, keep)), "voc")


def _exps(kind, mot_test_name="motchallenge"):
    from unicorn_torch.exp import det_mask as tdm
    from unicorn_torch.exp import track as tt
    from unicorn_torch.exp import track_mask as ttm
    from unicorn_tpu.exp import det_mask as jdm
    from unicorn_tpu.exp import track as jt
    from unicorn_tpu.exp import track_mask as jtm

    cls = {"uni": (jt.ExpTrack, tt.ExpTrack),
           "uni_mask": (jtm.ExpTrackMask, ttm.ExpTrackMask),
           "inst": (jdm.ExpDetMask, tdm.ExpDetMask)}[kind]
    out = []
    for c in cls:
        exp = c()
        exp.mot_test_name = mot_test_name
        exp.input_size = (64, 96)
        exp.max_labels = 12
        exp.samples_per_epoch = 40
        out.append(exp)
    return out


@pytest.mark.parametrize("kind", ["uni", "uni_mask"])
@pytest.mark.parametrize("mot_test_name", ["bdd100k", "motchallenge"])
def test_exp_specs_match_jax(root, monkeypatch, kind, mot_test_name):
    """Names and weights of every group; the same datasets found and
    skipped (CrowdHuman, CityPersons, ETHZ have no files here)."""
    monkeypatch.setenv("UNICORN_DATADIR", root)
    jexp, texp = _exps(kind, mot_test_name)
    jget = (jexp._sot_dataset_specs, jexp._mot_dataset_specs) \
        if kind == "uni" else (jexp._vos_dataset_specs,
                               jexp._mots_dataset_specs)
    tget = (texp._sot_dataset_specs, texp._mot_dataset_specs) \
        if kind == "uni" else (texp._vos_dataset_specs,
                               texp._mots_dataset_specs)
    for jg, tg in zip(jget, tget):
        js, ts = jg(root), tg(root)
        assert [(n, w) for n, w, _ in ts] == [(n, w) for n, w, _ in js]
        jd, jw = jexp._build_group(js)
        td, tw = texp._build_group(ts)
        assert tw == jw and [len(d) for d in td] == [len(d) for d in jd]
        assert [type(d).__name__ for d in td] == \
            [type(d).__name__ for d in jd]
    jplus, tplus = jexp.get_dataset(), texp.get_dataset()
    for g in ("sot_dataset", "mot_dataset"):
        assert getattr(tplus, g).p_datasets == getattr(jplus, g).p_datasets


def _compare_batches(jb, tb, kind):
    """uni: (images, targets, task ids); uni_mask: the same and masks;
    inst: (images, labels, masks). Every array equal."""
    assert len(jb) == len(tb) == (4 if kind == "uni_mask" else 3)
    for t, j in zip(tb, jb):
        np.testing.assert_array_equal(np.asarray(t), np.asarray(j))


@pytest.mark.parametrize("kind", ["uni", "uni_mask", "inst"])
def test_exp_loaders_match_jax(root, monkeypatch, kind):
    """get_data_loader of each exp over the on-disk mix, one worker: three
    batches (both tasks of the alternation) equal to JAX's after
    seed_everything(0); the exps' loaders are seeded 0."""
    monkeypatch.setenv("UNICORN_DATADIR", root)
    jexp, texp = _exps(kind)
    jl.seed_everything(0)
    jload = jexp.get_data_loader(2)
    jbs = [jload._make_batch() for _ in range(3)]
    tload = texp.get_data_loader(2)
    assert tload.workers == 1
    tbs = [tload._make_batch() for _ in range(3)]
    for jb, tb in zip(jbs, tbs):
        _compare_batches(jb, tb, kind)
    if kind != "inst":
        assert [int(b[2][0]) for b in tbs] == [1, 2, 1]
    else:
        assert tbs[0][2].shape == (2, 12, 16, 24)


def test_seeded_uni_loader_matches_jax(root, monkeypatch):
    """A UniLoader seeded 7 over the exp's on-disk mix against JAX's after
    seed_everything(7), at a multiscale size."""
    from unicorn_torch.data.transforms import TrainTransformOmni
    from unicorn_tpu.data.transforms import TrainTransformOmni as JTrans

    monkeypatch.setenv("UNICORN_DATADIR", root)
    jexp, texp = _exps("uni")
    jl.seed_everything(7)
    jload = jl.UniLoader(jexp.get_dataset(), JTrans(12), 2, (64, 96), seed=7)
    jload.set_input_size((96, 128))
    jbs = [jload._make_batch() for _ in range(4)]
    tload = tl.UniLoader(texp.get_dataset(), TrainTransformOmni(12), 2,
                         (64, 96), seed=7)
    tload.set_input_size((96, 128))
    for jb, tb in zip(jbs, [tload._make_batch() for _ in range(4)]):
        _compare_batches(jb, tb, "uni")
