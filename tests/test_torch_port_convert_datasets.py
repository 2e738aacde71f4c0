"""The port's dataset converters (unicorn_torch/tools/convert_datasets.py)
against tools/convert_datasets.py: from one synthetic layout under
tmp_path each writes the same json files (compared byte for byte), and
process_trackingnet unpacks the same tree."""
import importlib.util
import json
import os
import shutil
import zipfile

import numpy as np
import pytest

from unicorn_torch.evaluators import rle
from unicorn_torch.tools import convert_datasets as tcd

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference():
    spec = importlib.util.spec_from_file_location(
        "reference_convert_datasets",
        os.path.join(ROOT, "tools", "convert_datasets.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write(path, text):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)


def _mot_layout(root):
    """Two MOT17 sequences (one without gt) and a stray file: pedestrians,
    ignore regions of classes 2, 7, 8, 12, negative visibility and a
    zero mark."""
    rng = np.random.RandomState(0)
    for seq, n, gt in (("MOT17-02-FRCNN", 4, True),
                       ("MOT17-04-FRCNN", 2, False)):
        _write(os.path.join(root, "train", seq, "seqinfo.ini"),
               f"[Sequence]\nname={seq}\nimWidth=1920\nimHeight=1080\n"
               f"seqLength={n}\n")
        if gt:
            rows = []
            for f in range(1, n + 1):
                for tid, cls in enumerate((1, 1, 2, 7, 8, 12, 1), 1):
                    x, y = rng.uniform(0, 1500, 2)
                    vis = -0.5 if tid == 7 and f == 2 else rng.uniform(0, 1)
                    mark = 0 if tid == 2 and f == 3 else 1
                    rows.append(f"{f},{tid},{x:.2f},{y:.2f},90.5,240,{mark},"
                                f"{cls},{vis:.3f}")
            _write(os.path.join(root, "train", seq, "gt", "gt.txt"),
                   "\n".join(rows) + "\n")
    _write(os.path.join(root, "train", "README"), "not a sequence\n")


def _mots_layout(root):
    """A MOTS-Challenge sequence: pedestrians (class 2) with RLE masks, a
    car (class 1) and an empty mask."""
    h, w = 48, 64
    rows = []
    for f in range(1, 4):
        for oid, (cls, box) in enumerate(((2, (5, 8, 20, 30)),
                                          (2, (30, 2, 60, 20)),
                                          (1, (10, 10, 20, 20)),
                                          (2, None)), 1):
            m = np.zeros((h, w), np.uint8)
            if box:
                x0, y0, x1, y1 = box
                m[y0 + f:y1, x0:x1 - f] = 1
            rows.append(f"{f} {2000 + oid} {cls} {h} {w} "
                        f"{rle.encode(m)['counts']}")
    _write(os.path.join(root, "train", "0002", "gt", "gt.txt"),
           "\n".join(rows) + "\n")


def _crowdhuman_layout(root):
    recs = [{"ID": "a,1", "gtboxes": [
        {"tag": "person", "fbox": [1, 2, 30, 60]},
        {"tag": "mask", "fbox": [5, 5, 10, 10]},
        {"tag": "person", "fbox": [40, 2, 20, 50]}]},
        {"ID": "b,2", "gtboxes": []}]
    _write(os.path.join(root, "annotation_train.odgt"),
           "\n".join(json.dumps(r) for r in recs) + "\n")


def _cityperson_layout(root):
    _write(os.path.join(root, "annotations.json"), json.dumps({
        "images": [{"id": 1, "file_name": "x.png", "width": 8, "height": 6},
                   {"id": 2, "file_name": "y.png", "width": 8, "height": 6,
                    "video_id": 3, "frame_id": 4}],
        "annotations": [{"id": 1, "image_id": 1, "category_id": 1,
                         "bbox": [1, 1, 2, 3]},
                        {"id": 2, "image_id": 2, "category_id": 1,
                         "bbox": [0, 0, 4, 4], "iscrowd": 1,
                         "track_id": 9}]}))


def _zip(path, files):
    with zipfile.ZipFile(path, "w") as z:
        for name, data in files.items():
            z.writestr(name, data)


def _trackingnet_layout(root):
    """Chunk TRAIN_0 with two sequence zips and an annotation, chunk 1
    missing, chunk 2 without sequence zips."""
    os.makedirs(root)
    for i, seqs in ((0, ("seqA", "seqB")), (2, ())):
        inner = {}
        for s in seqs:
            buf = os.path.join(root, f"{s}.zip")
            _zip(buf, {f"{k}.jpg": f"{s}{k}" for k in range(3)})
            with open(buf, "rb") as f:
                inner[f"zips/{s}.zip"] = f.read()
            os.remove(buf)
        inner["anno/x.txt"] = "1,2,3,4\n"
        _zip(os.path.join(root, f"TRAIN_{i}.zip"), inner)


LAYOUTS = {
    "mot17": (_mot_layout, lambda m, r: m.convert_mot(r, "train"),
              ["annotations/train.json"]),
    "mot20": (_mot_layout, lambda m, r: m.convert_mot(
        r, "train", out_name="train_mot20.json", mot20=True),
              ["annotations/train_mot20.json"]),
    "mot17_omni": (_mot_layout, lambda m, r: (m.convert_mot(r, "train"),
                                              m.convert_mot17_to_omni(r)),
                   ["annotations/train.json", "annotations/train_omni.json"]),
    "mots": (_mots_layout, lambda m, r: m.convert_mots(r, "train"),
             ["annotations/train_mots.json"]),
    "crowdhuman": (_crowdhuman_layout,
                   lambda m, r: m.convert_crowdhuman(r, "train"),
                   ["annotations/train.json"]),
    "cityperson": (_cityperson_layout,
                   lambda m, r: m.convert_cityscapes_like(
                       r, "annotations.json", "train"),
                   ["annotations/train.json"]),
}


@pytest.mark.parametrize("kind", sorted(LAYOUTS))
def test_converters_write_the_reference_files(kind, tmp_path):
    layout, run, outputs = LAYOUTS[kind]
    ref_root, port_root = str(tmp_path / "ref"), str(tmp_path / "port")
    layout(ref_root)
    shutil.copytree(ref_root, port_root)
    run(_reference(), ref_root)
    run(tcd, port_root)
    for rel in outputs:
        with open(os.path.join(ref_root, rel), "rb") as f:
            want = f.read()
        with open(os.path.join(port_root, rel), "rb") as f:
            assert f.read() == want, rel
        assert json.loads(want), rel


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            path = os.path.join(d, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_process_trackingnet_unpacks_the_reference_tree(tmp_path):
    ref_root, port_root = str(tmp_path / "ref"), str(tmp_path / "port")
    _trackingnet_layout(ref_root)
    shutil.copytree(ref_root, port_root)
    _reference().process_trackingnet(ref_root, n_chunks=3)
    tcd.process_trackingnet(port_root, n_chunks=3)
    tree = _tree(port_root)
    assert tree == _tree(ref_root)
    assert "TrackingNet/TRAIN_0/frames/seqB/2.jpg" in tree


def test_main_parses_like_the_reference(tmp_path, monkeypatch):
    ref_root, port_root = str(tmp_path / "ref"), str(tmp_path / "port")
    _mot_layout(ref_root)
    shutil.copytree(ref_root, port_root)
    ref = _reference()
    for mod, root in ((ref, ref_root), (tcd, port_root)):
        monkeypatch.setattr("sys.argv", ["convert_datasets", "mot17",
                                         "--root", root])
        mod.main()
    rel = os.path.join("annotations", "train.json")
    assert _tree(port_root)[rel] == _tree(ref_root)[rel]
