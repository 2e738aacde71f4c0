"""The port's benchmark registry and sequence loaders
(unicorn_torch/harness/datasets.py) against the JAX package's, on the CPU.

The nine layouts (LaSOT, GOT-10k val and test, TrackingNet, OTB-100, NFS,
UAV123, TC128, DAVIS 2016 / 2017, YouTube-VOS 2018) are written under one
tmp_path root; with UNICORN_DATADIR there, every one of the 11 registry keys
must give the same Sequences in both packages: names, frame paths,
ground-truth arrays (equal, NaN rows included), mask paths, object ids and
dataset tags. Every loud failure (missing root, list, annotation, frame
folder; a frame range that does not match the annotations) must raise the
same exception type in both. The shipped LaSOT split and NFS / UAV123 tables
must equal the JAX package's files byte for byte, and JAX's own registry
tests (tests/test_harness_registry.py) run again with the port's functions
patched in.
"""
import inspect
import json
import os

import numpy as np
import pytest

import test_harness_registry as reg_cases
from unicorn_torch.data import image_io as tio
from unicorn_torch.harness import datasets as tds
from unicorn_torch.harness import davis_metrics as tdm
from unicorn_tpu.harness import datasets as jds
from unicorn_tpu.harness import davis_metrics as jdm
from unicorn_tpu.utils import label_ops as jlabel

KEYS = ("lasot", "got10k_test", "got10k_val", "trackingnet", "otb", "nfs",
        "uav", "tc128", "dv2016", "dv2017", "yt2018")


def _touch(path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    open(path, "wb").close()


def _gt(rng, n, delim=","):
    return "\n".join(delim.join(f"{v:.2f}" for v in row)
                     for row in rng.rand(n, 4) * 100) + "\n"


def _write(path, text):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)


def _tree(root):
    """Every benchmark layout under root, as $UNICORN_DATADIR expects it."""
    rng = np.random.RandomState(0)
    # LaSOT: the first two names of the split only (load_lasot(names=...))
    for name in ("airplane-1", "airplane-13"):
        _write(os.path.join(root, "LaSOT", "airplane", name,
                            "groundtruth.txt"), _gt(rng, 4))
    # GOT-10k: val ordered by list.txt, test by its sorted directories; the
    # ground truth tab- and space-separated (_load_txt's fallbacks)
    for split, names, delim in (("val", ["GOT-10k_Val_000002",
                                         "GOT-10k_Val_000001"], "\t"),
                                ("test", ["GOT-10k_Test_000001",
                                          "GOT-10k_Test_000002"], " ")):
        for k, name in enumerate(names):
            sdir = os.path.join(root, "GOT10K", split, name)
            _write(os.path.join(sdir, "groundtruth.txt"),
                   _gt(rng, 3 + k if split == "val" else 1, delim))
            for i in range(3 + k):
                _touch(os.path.join(sdir, f"{i + 1:08d}.jpg"))
        if split == "val":
            _write(os.path.join(root, "GOT10K", split, "list.txt"),
                   "\n".join(names) + "\n")
    # TrackingNet TEST: anno/<seq>.txt (first frame only), frames/<seq>/i.jpg
    for name, n in (("tn_b", 3), ("tn_a", 2)):
        _write(os.path.join(root, "TrackingNet", "TEST", "anno",
                            f"{name}.txt"), _gt(rng, 1))
        for i in range(n):
            _touch(os.path.join(root, "TrackingNet", "TEST", "frames", name,
                                f"{i}.jpg"))
    # OTB-100: a range sequence, a two-target one, an init-omit one, Board's
    # 5-digit numbering, a renumbered mirror of a range sequence
    otb = os.path.join(root, "OTB100")
    for dirname, files, rows, first in (
            ("BlurCar3", ["groundtruth_rect.txt"], 357, "0003.jpg"),
            ("Jogging", ["groundtruth_rect.1.txt", "groundtruth_rect.2.txt"],
             6, "0001.jpg"),
            ("Tiger1", ["groundtruth_rect.txt"], 9, "0001.jpg"),
            ("Board", ["groundtruth_rect.txt"], 5, "00001.jpg"),
            ("Basketball", ["groundtruth_rect.txt"], 4, "0001.jpg")):
        for f in files:
            _write(os.path.join(otb, dirname, f), _gt(rng, rows))
        _touch(os.path.join(otb, dirname, "img", first))
    _write(os.path.join(otb, "BlurCar4", "groundtruth_rect.txt"),
           _gt(rng, 380))
    for i in range(380):
        _touch(os.path.join(otb, "BlurCar4", "img", f"{i + 1:05d}.jpg"))
    os.makedirs(os.path.join(otb, "not_a_sequence"))
    # NFS / UAV123: every annotation of the tables, NaN rows in UAV's, a
    # few written with another delimiter than the table's
    for key, sub in (("nfs", "nfs"), ("uav", "UAV123")):
        manifest = json.loads(tds._package_file("sot_benchmarks.json"))[key]
        for k, info in enumerate(manifest["sequences"]):
            delim = manifest["delimiter"] if k % 7 else " "
            text = _gt(rng, 3, delim)
            if key == "uav" and k % 5 == 1:
                text += delim.join(["NaN"] * 4) + "\n"
            _write(os.path.join(root, sub, info["anno_path"]), text)
    # TC128: a directory scan with valid ranges
    for name, lo, hi in (("Airport_ce", 1, 3), ("Ball_ce1", 2, 4)):
        sdir = os.path.join(root, "TC128", name)
        _write(os.path.join(sdir, f"{name}_gt.txt"), _gt(rng, hi - lo + 1))
        _write(os.path.join(sdir, f"{name}_frames.txt"), f"{lo},{hi}")
        os.makedirs(os.path.join(sdir, "img"), exist_ok=True)
    # DAVIS 2017 and 2016
    for sub, year, names in (("DAVIS", "2017", ["dogs", "bike"]),
                             ("DAVIS2016", "2016", ["cows"])):
        d = os.path.join(root, sub)
        _write(os.path.join(d, "ImageSets", year, "val.txt"),
               "\n".join(names) + "\n")
        for name in names:
            for i in range(3):
                _touch(os.path.join(d, "JPEGImages", "480p", name,
                                    f"{i:05d}.jpg"))
                _touch(os.path.join(d, "Annotations", "480p", name,
                                    f"{i:05d}.png"))
    # YouTube-VOS 2018 valid: sparse annotations, an object entering
    # mid-video, string ids sorted numerically, a video without objects
    yt = os.path.join(root, "ytbvos18", "valid")
    meta = {"videos": {
        "b_vid": {"objects": {"10": {"frames": ["00000"]},
                              "2": {"frames": ["00000", "00005"]},
                              "3": {"frames": ["00005"]}}},
        "a_vid": {}}}
    _write(os.path.join(yt, "meta.json"), json.dumps(meta))
    for f in ("00000", "00005", "00010"):
        _touch(os.path.join(yt, "JPEGImages", "b_vid", f"{f}.jpg"))
        _touch(os.path.join(yt, "JPEGImages", "a_vid", f"{f}.jpg"))
    for f in ("00000", "00005"):
        _touch(os.path.join(yt, "Annotations", "b_vid", f"{f}.png"))
    return root


def _assert_same(seqs_t, seqs_j):
    assert len(seqs_t) == len(seqs_j) > 0
    for st, sj in zip(seqs_t, seqs_j):
        assert (st.name, st.frames, st.masks, st.object_ids, st.dataset) == \
            (sj.name, sj.frames, sj.masks, sj.object_ids, sj.dataset)
        np.testing.assert_array_equal(st.ground_truth_rect,
                                      sj.ground_truth_rect)
        assert st.ground_truth_rect.dtype == sj.ground_truth_rect.dtype
        assert st.init_bbox == sj.init_bbox or np.isnan(
            st.init_bbox).any()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return _tree(str(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("key", KEYS)
def test_registry_key_loads_the_same_sequences(tree, key, monkeypatch):
    monkeypatch.setenv("UNICORN_DATADIR", tree)
    if key == "lasot":
        names = ["airplane-1", "airplane-13"]
        _assert_same(tds.load_lasot(names=names),
                     jds.load_lasot(names=names))
        for get in (tds.get_dataset, jds.get_dataset):  # all 280 demanded
            with pytest.raises(FileNotFoundError):
                get(key)
        return
    seqs = tds.get_dataset(key)
    _assert_same(seqs, jds.get_dataset(key))
    if key == "otb":
        assert [s.name for s in seqs] == [
            "Basketball", "BlurCar3", "BlurCar4", "Board", "Jogging_1",
            "Jogging_2", "Tiger1"]
    if key in ("nfs", "uav"):
        assert len(seqs) == {"nfs": 100, "uav": 123}[key]
    if key == "yt2018":
        assert [s.object_ids for s in seqs] == [None, [2, 3, 10]]


def test_registry_keys_and_unknown_name():
    assert tuple(tds.DATASET_REGISTRY) == tuple(jds.DATASET_REGISTRY) == KEYS
    for get in (tds.get_dataset, jds.get_dataset):
        with pytest.raises(KeyError):
            get("vot2020")


def test_package_data_equals_the_jax_package_files():
    jdir = os.path.dirname(jds.__file__)
    for name in ("lasot_test_split.txt", "sot_benchmarks.json"):
        with open(os.path.join(jdir, name)) as f:
            assert tds._package_file(name) == f.read()
    assert tds.lasot_test_names() == jds.lasot_test_names()


def _break(root, what):
    """A copy of the loud failure `what` in the tree at root; returns the
    loader call that must raise."""
    if what == "lasot_listed_missing":
        return lambda m: m.load_lasot(names=["airplane-1", "airplane-9"])
    if what == "got10k_no_groundtruth":
        os.makedirs(os.path.join(root, "GOT10K", "val", "GOT-10k_Val_000003"))
        with open(os.path.join(root, "GOT10K", "val", "list.txt"), "a") as f:
            f.write("GOT-10k_Val_000003\n")
        return lambda m: m.load_got10k(split="val")
    if what == "trackingnet_no_frames":
        _write(os.path.join(root, "TrackingNet", "TEST", "anno", "zz.txt"),
               "1,2,3,4\n")
        return lambda m: m.load_trackingnet()
    if what == "otb_no_annotation":
        os.makedirs(os.path.join(root, "OTB100", "Broken", "img"))
        return lambda m: m.load_otb()
    if what == "otb_mirror_wrong_length":
        os.remove(os.path.join(root, "OTB100", "BlurCar4", "img",
                               "00380.jpg"))
        return lambda m: m.load_otb()
    if what == "nfs_annotation_missing":
        os.remove(os.path.join(root, "nfs", "anno", "nfs_Gymnastics.txt"))
        return lambda m: m.load_nfs()
    if what == "uav_root_missing":
        return lambda m: m.load_uav(root=os.path.join(root, "nope"))
    if what == "tc128_no_range_file":
        os.remove(os.path.join(root, "TC128", "Ball_ce1",
                               "Ball_ce1_frames.txt"))
        return lambda m: m.load_tc128()
    if what == "tc128_range_mismatch":
        _write(os.path.join(root, "TC128", "Ball_ce1", "Ball_ce1_frames.txt"),
               "2,9")
        return lambda m: m.load_tc128()
    if what == "tc128_empty":
        os.makedirs(os.path.join(root, "empty"))
        return lambda m: m.load_tc128(root=os.path.join(root, "empty"))
    if what == "davis_no_split":
        os.remove(os.path.join(root, "DAVIS", "ImageSets", "2017", "val.txt"))
        return lambda m: m.load_davis()
    if what == "ytvos_no_frames":
        meta = os.path.join(root, "ytbvos18", "valid", "meta.json")
        with open(meta) as f:
            d = json.load(f)
        d["videos"]["c_vid"] = {}
        _write(meta, json.dumps(d))
        return lambda m: m.load_ytvos()
    if what == "ytvos_no_meta":
        return lambda m: m.load_ytvos(root=os.path.join(root, "nope"))
    raise KeyError(what)


@pytest.mark.parametrize("what", [
    "lasot_listed_missing", "got10k_no_groundtruth", "trackingnet_no_frames",
    "otb_no_annotation", "otb_mirror_wrong_length", "nfs_annotation_missing",
    "uav_root_missing", "tc128_no_range_file", "tc128_range_mismatch",
    "tc128_empty", "davis_no_split", "ytvos_no_frames", "ytvos_no_meta"])
def test_loud_failures_match(tmp_path, what, monkeypatch):
    root = _tree(str(tmp_path))
    monkeypatch.setenv("UNICORN_DATADIR", root)
    call = _break(root, what)
    errors = []
    for mod in (tds, jds):
        with pytest.raises((FileNotFoundError, ValueError)) as e:
            call(mod)
        errors.append(type(e.value))
    assert errors[0] is errors[1], errors


@pytest.mark.parametrize("loader", ["load_lasot", "load_got10k",
                                    "load_trackingnet", "load_otb",
                                    "load_nfs", "load_uav", "load_tc128",
                                    "load_davis", "load_ytvos"])
def test_missing_roots_raise_in_both(tmp_path, loader):
    for mod in (tds, jds):
        with pytest.raises(FileNotFoundError):
            getattr(mod, loader)(root=str(tmp_path / "nope"))


CASES = [name for name, fn in inspect.getmembers(reg_cases,
                                                 inspect.isfunction)
         if name.startswith("test_")]


@pytest.mark.parametrize("case", CASES)
def test_jax_registry_cases_on_the_port(case, monkeypatch, tmp_path):
    """tests/test_harness_registry.py with the port's functions in place of
    JAX's: in that module, and (for the names its cases import inside the
    function) in the JAX package's modules, for this test only."""
    for name in ("lasot_test_names", "load_davis", "load_got10k",
                 "load_lasot", "load_trackingnet"):
        monkeypatch.setattr(reg_cases, name, getattr(tds, name))
    for name in ("DATASET_REGISTRY", "load_nfs", "load_uav", "load_tc128",
                 "load_ytvos", "load_otb"):
        monkeypatch.setattr(jds, name, getattr(tds, name))
    monkeypatch.setattr(jlabel, "read_indexed_mask", tio.read_indexed_mask)
    monkeypatch.setattr(jdm, "_seg2bmap", tdm._seg2bmap)
    fn = getattr(reg_cases, case)
    if "tmp_path" in inspect.signature(fn).parameters:
        fn(tmp_path)
    else:
        fn()
