"""SOT / VOS benchmark registry and sequence loaders (port of
unicorn_tpu/harness/datasets.py).

A Sequence is frame paths plus ground-truth boxes (and mask paths for VOS).
The registry holds the reference's benchmarks: LaSOT, GOT-10k test / val,
TrackingNet, OTB-100, NFS, UAV123, TC128, DAVIS 2016 / 2017 and YouTube-VOS
2018. A loader raises on a missing root, list or annotation: a silently
smaller evaluation set would report a wrong score.

The LaSOT test split (280 names) and the NFS / UAV123 sequence tables ship
beside this module as package data (`lasot_test_split.txt`,
`sot_benchmarks.json`).
"""
from __future__ import annotations

import glob
import json
import os
from dataclasses import dataclass
from importlib import resources
from typing import Optional

import numpy as np


def env_data_root():
    return os.environ.get(
        "UNICORN_DATADIR",
        os.path.join(os.getcwd(), "datasets"),
    )


def _package_file(name: str) -> str:
    return resources.files(__package__).joinpath(name).read_text()


@dataclass
class Sequence:
    name: str
    frames: list                      # frame paths
    ground_truth_rect: np.ndarray     # (N, 4) xywh; may be only frame 0 for test sets
    object_ids: Optional[list] = None
    masks: Optional[list] = None      # per-frame mask paths (VOS)
    dataset: str = ""

    @property
    def init_bbox(self):
        return list(self.ground_truth_rect[0])


def _load_txt(path):
    """(N, 4) boxes from a comma-, space- or tab-separated text file; a file
    that is missing or none of the three parses raises ValueError."""
    for d in [",", None, "\t"]:
        try:
            return np.loadtxt(path, delimiter=d).reshape(-1, 4)
        except (ValueError, OSError):
            continue
    raise ValueError(f"cannot parse {path}")


def lasot_test_names():
    """The 280-sequence LaSOT test split (the reference's
    lasotdataset.py:61)."""
    names = [l.strip() for l in _package_file("lasot_test_split.txt")
             .splitlines() if l.strip()]
    if len(names) != 280:
        raise ValueError(f"corrupt LaSOT split file: {len(names)} entries")
    return names


def load_lasot(root=None, split="test", names=None):
    """LaSOT test split: root/<cls>/<cls>-<k>/. A missing root or listed
    sequence raises FileNotFoundError."""
    root = root or os.path.join(env_data_root(), "LaSOT")
    if not os.path.isdir(root):
        raise FileNotFoundError(f"LaSOT root not found: {root}")
    names = names if names is not None else lasot_test_names()
    seqs = []
    for name in names:
        cls = name.split("-")[0]
        sdir = os.path.join(root, cls, name)
        gt_path = os.path.join(sdir, "groundtruth.txt")
        if not os.path.exists(gt_path):
            raise FileNotFoundError(
                f"LaSOT test sequence missing: {name} ({gt_path})")
        gt = _load_txt(gt_path)
        frames = [os.path.join(sdir, "img", f"{i + 1:08d}.jpg")
                  for i in range(len(gt))]
        seqs.append(Sequence(name, frames, gt, dataset="lasot"))
    return seqs


def load_got10k(root=None, split="test"):
    """GOT-10k: the sequence order is the dataset's own list.txt (else the
    sorted directories); raises on a missing root or annotation."""
    root = root or os.path.join(env_data_root(), "GOT10K", split)
    if not os.path.isdir(root):
        raise FileNotFoundError(f"GOT10K {split} root not found: {root}")
    seqs = []
    list_file = os.path.join(root, "list.txt")
    if os.path.exists(list_file):
        with open(list_file) as f:
            names = [l.strip() for l in f if l.strip()]
    else:
        names = [d for d in sorted(os.listdir(root))
                 if os.path.isdir(os.path.join(root, d))]
    for name in names:
        sdir = os.path.join(root, name)
        gt = _load_txt(os.path.join(sdir, "groundtruth.txt"))
        n_frames = len([f for f in os.listdir(sdir) if f.endswith(".jpg")])
        frames = [os.path.join(sdir, f"{i + 1:08d}.jpg")
                  for i in range(n_frames)]
        seqs.append(Sequence(name, frames, gt, dataset="got10k"))
    return seqs


def load_trackingnet(root=None):
    root = root or os.path.join(env_data_root(), "TrackingNet")
    seqs = []
    tdir = os.path.join(root, "TEST")
    if not os.path.isdir(tdir):
        raise FileNotFoundError(f"TrackingNet TEST root not found: {tdir}")
    anno = os.path.join(tdir, "anno")
    for f in sorted(os.listdir(anno)):
        if not f.endswith(".txt"):
            continue
        name = f[:-4]
        gt = _load_txt(os.path.join(anno, f))
        fdir = os.path.join(tdir, "frames", name)
        n = len(os.listdir(fdir))
        frames = [os.path.join(fdir, f"{i}.jpg") for i in range(n)]
        seqs.append(Sequence(name, frames, gt, dataset="trackingnet"))
    return seqs


# OTB-100 per-sequence protocol facts a plain directory scan misses (the
# reference's otbdataset.py sequence table): annotated frame RANGES for
# sequences whose image folder holds more frames than are annotated,
# Tiger1's 5 init-omitted frames, the two-target sequences that ship
# numbered annotation files (each its own benchmark entry), and Board's
# 5-digit frame numbering.
_OTB_RANGE = {"BlurCar1": (247, 988), "BlurCar3": (3, 359),
              "BlurCar4": (18, 397), "David": (300, 770)}
_OTB_INIT_OMIT = {"Tiger1": 5}
_OTB_MULTI = {"Human4": [("Human4_2", "groundtruth_rect.2.txt")],
              "Jogging": [("Jogging_1", "groundtruth_rect.1.txt"),
                          ("Jogging_2", "groundtruth_rect.2.txt")],
              "Skating2": [("Skating2_1", "groundtruth_rect.1.txt"),
                           ("Skating2_2", "groundtruth_rect.2.txt")]}
_OTB_NZ = {"Board": 5}


def load_otb(root=None):
    """OTB-100: root/<seq>/img + groundtruth_rect.txt, with the ranges,
    init-omits and dual annotations of the tables above."""
    root = root or os.path.join(env_data_root(), "OTB100")
    seqs = []
    if not os.path.isdir(root):
        raise FileNotFoundError(f"OTB root not found: {root}")
    for dirname in sorted(os.listdir(root)):
        sdir = os.path.join(root, dirname)
        img_dir = os.path.join(sdir, "img")
        if not os.path.isdir(img_dir):
            continue  # not an OTB sequence directory
        for name, anno_file in _OTB_MULTI.get(
                dirname, [(dirname, "groundtruth_rect.txt")]):
            gt_path = os.path.join(sdir, anno_file)
            if not os.path.exists(gt_path):
                raise FileNotFoundError(f"OTB annotation missing: {gt_path}")
            gt = _load_txt(gt_path)
            omit = _OTB_INIT_OMIT.get(name, 0)
            start, end = _OTB_RANGE.get(name, (1, len(gt)))
            nz = _OTB_NZ.get(name, 4)
            if os.path.exists(os.path.join(img_dir, f"{start:0{nz}d}.jpg")):
                frames = [os.path.join(img_dir, f"{i:0{nz}d}.jpg")
                          for i in range(start + omit, end + 1)]
            else:
                # a mirror with renumbered frames: only an exact-length
                # folder keeps frames aligned with the ground-truth rows
                files = sorted(f for f in os.listdir(img_dir)
                               if f.endswith(".jpg"))
                if len(files) != end - start + 1:
                    raise FileNotFoundError(
                        f"OTB {name}: expected frames {start}..{end} under "
                        f"{img_dir}, found {len(files)} jpgs")
                frames = [os.path.join(img_dir, f) for f in files[omit:]]
            seqs.append(Sequence(name, frames, gt[omit:], dataset="otb"))
    return seqs


def load_davis(root=None, year="2017", split="val"):
    """DAVIS 2016 / 2017 (VOS): root/JPEGImages/480p/<seq>,
    root/Annotations/480p/<seq>, the split in ImageSets/<year>/."""
    root = root or os.path.join(env_data_root(), f"DAVIS{year}"
                                if year != "2017" else "DAVIS")
    seqs = []
    set_file = os.path.join(root, "ImageSets", year, f"{split}.txt")
    if not os.path.exists(set_file):
        raise FileNotFoundError(f"DAVIS split file not found: {set_file}")
    with open(set_file) as f:
        names = [l.strip() for l in f if l.strip()]
    for name in names:
        jdir = os.path.join(root, "JPEGImages", "480p", name)
        adir = os.path.join(root, "Annotations", "480p", name)
        frames = [os.path.join(jdir, f) for f in sorted(os.listdir(jdir))]
        masks = [os.path.join(adir, f) for f in sorted(os.listdir(adir))]
        seqs.append(Sequence(name, frames, np.zeros((1, 4)), masks=masks,
                             dataset=f"davis{year}"))
    return seqs


def _load_manifest_dataset(key, root):
    """NFS / UAV123 from the sequence tables of sot_benchmarks.json (names,
    frame ranges, zero-padding, annotation paths; the reference's
    nfsdataset.py / uavdataset.py). Raises on a missing root or annotation
    file."""
    if not os.path.isdir(root):
        raise FileNotFoundError(f"{key} root not found: {root}")
    manifest = json.loads(_package_file("sot_benchmarks.json"))[key]
    delim = manifest["delimiter"]
    seqs = []
    for info in manifest["sequences"]:
        omit = int(info.get("initOmit", 0))
        frames = [
            os.path.join(root, info["path"],
                         f"{i:0{info['nz']}d}.{info['ext']}")
            for i in range(info["startFrame"] + omit, info["endFrame"] + 1)
        ]
        anno = os.path.join(root, info["anno_path"])
        if not os.path.exists(anno):
            raise FileNotFoundError(f"{key} annotation missing: {anno}")
        try:
            gt = np.loadtxt(anno, delimiter=delim).reshape(-1, 4)
        except ValueError:
            gt = _load_txt(anno)
        seqs.append(Sequence(info["name"], frames, gt[omit:], dataset=key))
    return seqs


def load_nfs(root=None):
    """NFS-30 (100 sequences)."""
    return _load_manifest_dataset("nfs", root or os.path.join(env_data_root(),
                                                              "nfs"))


def load_uav(root=None):
    """UAV123 (123 sequences)."""
    return _load_manifest_dataset("uav", root or os.path.join(env_data_root(),
                                                              "UAV123"))


def load_tc128(root=None):
    """Temple-Color 128: a directory scan, each sequence's *_gt.txt and the
    valid frame range of its *_frames.txt."""
    root = root or os.path.join(env_data_root(), "TC128")
    if not os.path.isdir(root):
        raise FileNotFoundError(f"TC128 root not found: {root}")
    anno_files = sorted(glob.glob(os.path.join(root, "*/*_gt.txt")))
    if not anno_files:
        raise FileNotFoundError(f"TC128 root has no */*_gt.txt: {root}")
    seqs = []
    for anno in anno_files:
        sdir = os.path.dirname(anno)
        name = os.path.basename(sdir)
        range_files = glob.glob(os.path.join(sdir, "*_frames.txt"))
        if not range_files:
            raise FileNotFoundError(f"TC128 frame-range file missing: {sdir}")
        lo, hi = np.loadtxt(range_files[0], dtype=int, delimiter=",")[:2]
        frames = [os.path.join(sdir, "img", f"{i:04d}.jpg")
                  for i in range(int(lo), int(hi) + 1)]
        gt = np.loadtxt(anno, delimiter=",").reshape(-1, 4)
        if len(frames) != len(gt):
            raise ValueError(f"TC128 {name}: {len(frames)} frames vs "
                             f"{len(gt)} annotations")
        seqs.append(Sequence(name, frames, gt, dataset="tc128"))
    return seqs


def load_ytvos(root=None, year="2018", split="valid"):
    """YouTube-VOS evaluation split: split/JPEGImages/<seq>,
    split/Annotations/<seq> (first-appearance annotations only) and
    meta.json listing each object's frames. Object ids are ints, sorted
    numerically; the J&F scorer (harness/davis_metrics.py) scores each
    object from its first appearance."""
    root = root or os.path.join(env_data_root(), f"ytbvos{year[2:]}")
    sdir = os.path.join(root, split)
    meta_file = os.path.join(sdir, "meta.json")
    if not os.path.exists(meta_file):
        raise FileNotFoundError(f"YouTube-VOS meta.json not found: {meta_file}")
    with open(meta_file) as f:
        meta = json.load(f)["videos"]
    seqs = []
    for name in sorted(meta):
        jdir = os.path.join(sdir, "JPEGImages", name)
        adir = os.path.join(sdir, "Annotations", name)
        if not os.path.isdir(jdir):
            raise FileNotFoundError(f"YouTube-VOS frames missing: {jdir}")
        frames = [os.path.join(jdir, f) for f in sorted(os.listdir(jdir))]
        masks = ([os.path.join(adir, f) for f in sorted(os.listdir(adir))]
                 if os.path.isdir(adir) else [])
        obj_ids = (sorted(int(k) for k in meta[name]["objects"])
                   if "objects" in meta[name] else None)
        seqs.append(Sequence(name, frames, np.zeros((1, 4)), masks=masks,
                             object_ids=obj_ids, dataset=f"yt{year}"))
    return seqs


# the reference's benchmark registry (external/lib/test/evaluation/
# datasets.py:9-26)
DATASET_REGISTRY = {
    "lasot": load_lasot,
    "got10k_test": lambda: load_got10k(split="test"),
    "got10k_val": lambda: load_got10k(split="val"),
    "trackingnet": load_trackingnet,
    "otb": load_otb,
    "nfs": load_nfs,
    "uav": load_uav,
    "tc128": load_tc128,
    "dv2016": lambda: load_davis(year="2016"),
    "dv2017": lambda: load_davis(year="2017"),
    "yt2018": lambda: load_ytvos(year="2018"),
}


def get_dataset(name: str):
    if name not in DATASET_REGISTRY:
        raise KeyError(f"unknown dataset {name}; have {list(DATASET_REGISTRY)}")
    return DATASET_REGISTRY[name]()
