"""The port's tools/track_omni.py against the JAX package's, on the CPU,
with the same weights: QDTrack and DeepSORT on tests/test_cli_e2e.py's MOT
fixture (its frames at the exps' test_size here), --mots (CondInst masks,
MOTS-Challenge txts, --score-gt) with its tiny mask exp, and --dataset
bdd on tests/test_bdd_e2e.py's BDD100K fixture.

The exps, weights and tolerances are those of
tests/test_torch_port_tools_cli.py (one head attention block a level, the
obj / cls biases raised, one set of JAX params in a JAX and a port
checkpoint): the same frame ids and track ids, boxes within 1e-2 px,
scores within 1e-3; the exps' test_conf is set to 0.9 through the tools'
trailing `key value` overrides (about a tenth of the raised anchors score
above it: a frame holds a few tracks, not 128 overlapping ones whose
associations tie). MOTS masks: the same object ids a frame and the decoded
masks (at the frame's resolution, thresholded at 0.3) equal on at least
99.9% of the pixels; the port's --score-gt with JAX's txts as the ground
truth equal to JAX's scorer on the same pair, MOTSP 1. BDD: the same
scores.json / seg_scores.json within 1e-6.
"""
import json
import os
import shutil
from unittest import mock

import numpy as np
import pytest
import torch

import test_bdd_e2e as bdd
import test_cli_e2e as cli
import test_torch_port_tools_cli as tc
from unicorn_torch.evaluators import rle as trle
from unicorn_torch.tools import track_omni as tomni

MASK_EXP = cli.TRACK_MASK_EXP.replace(
    'self.test_size = (64, 96)',
    'self.test_size = (64, 96)\n        self.test_ann = "test_tiny.json"\n'
    '        self.test_name = "test"')


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _write_mot_fixture_at_test_size(datadir, H=64, W=96):
    """tests/test_cli_e2e.py's MOT fixture (one video of six frames, a
    moving box on a noise texture here) with the frames at the exps'
    test_size: both drivers letterbox on their device, and only at r = 1
    are the two letterboxes equal (tests/test_torch_port_omni.py)."""
    import cv2

    img_dir = os.path.join(datadir, "mot", "test", "v0")
    ann_dir = os.path.join(datadir, "mot", "annotations")
    os.makedirs(img_dir)
    os.makedirs(ann_dir)
    rng = np.random.RandomState(0)
    images, anns = [], []
    for t in range(6):
        img = (rng.rand(H, W, 3) * 60).astype(np.uint8)
        x, y, w, h = 10 + 6 * t, 20, 30, 30
        img[y:y + h, x:x + w] = 255
        cv2.imwrite(os.path.join(img_dir, f"{t:06d}.jpg"), img)
        images.append({"id": t + 1, "file_name": f"v0/{t:06d}.jpg",
                       "height": H, "width": W, "frame_id": t + 1,
                       "video_id": 1})
        anns.append({"id": t + 1, "image_id": t + 1, "category_id": 1,
                     "bbox": [x, y, w, h], "area": w * h, "iscrowd": 0,
                     "track_id": 1})
    with open(os.path.join(ann_dir, "test_tiny.json"), "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": 1, "name": "person"}]}, f)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("tools_omni")
    data = str(root / "data")
    _write_mot_fixture_at_test_size(data)
    bdd._make_fixture(os.path.join(data, "bdd100k"), with_mots=True)
    labels = os.path.join(data, "bdd100k", "labels")
    os.makedirs(os.path.join(labels, "box_track_20"))
    shutil.copyfile(os.path.join(labels, "seg_track_20", "rles", "val.json"),
                    os.path.join(labels, "box_track_20", "val.json"))
    return {"root": root, "data": data,
            "track": tc.write_weights(str(root), cli.TRACK_EXP, "track"),
            "mask": tc.write_weights(str(root), MASK_EXP, "mask")}


def _argv(w, which, out, extra):
    # test_conf 0.9 (an exp override): about a tenth of the anchors score
    # above it, so that a frame holds a few tracks, not 128 overlapping ones
    return ["-f", w[f"{which}_exp"], "-c", w[f"{which}_ckpt"],
            "--result-dir", out, *extra, "test_conf", "0.9"]


@pytest.mark.parametrize("tracker", ["qd", "deepsort"])
def test_track_omni_matches_jax(setup, monkeypatch, tracker):
    monkeypatch.setenv("UNICORN_DATADIR", setup["data"])
    w = setup["track"]
    jdir, tdir = (str(setup["root"] / f"{k}_{tracker}") for k in "jt")
    extra = ["--tracker", tracker]
    ref = tc.captured_mot_results(
        lambda: tc.run_jax_tool("track_omni", _argv(w, "jax", jdir, extra)))
    port = tomni.main(_argv(w, "torch", tdir, ["--device", "cpu"] + extra))
    assert tc.assert_same_tracks(port, ref) > 0
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)) == ["v0.txt"]


def _captured_mots(module, run):
    got = {}
    real = module.write_mots_txt

    def capture(path, frames):
        got[os.path.splitext(os.path.basename(path))[0]] = list(frames)
        real(path, frames)

    with mock.patch.object(module, "write_mots_txt", capture):
        run()
    return got


def test_track_omni_mots_matches_jax(setup, monkeypatch, capsys):
    """--mots: the same ids and masks as JAX's; --score-gt against JAX's
    own txts: JAX's scorer's numbers, the matched masks equal."""
    from unicorn_tpu.evaluators import mots_metrics as jmots

    monkeypatch.setenv("UNICORN_DATADIR", setup["data"])
    w = setup["mask"]
    jdir, tdir = str(setup["root"] / "j_mots"), str(setup["root"] / "t_mots")
    ref = _captured_mots(jmots, lambda: tc.run_jax_tool(
        "track_omni", _argv(w, "jax", jdir, ["--mots"])))
    port = _captured_mots(tomni, lambda: tomni.main(_argv(
        w, "torch", tdir, ["--device", "cpu", "--score-gt", jdir,
                           "--mots"])))
    assert sorted(port) == sorted(ref) == ["v0"]
    n_masks = 0
    for (fp, ip, cp, rp), (fr, ir, cr, rr) in zip(port["v0"], ref["v0"]):
        assert fp == fr and ip == ir and cp == cr == [2] * len(ir)
        for a, b in zip(rp, rr):
            ma, mb = trle.decode(a), trle.decode(b)
            assert ma.shape == mb.shape == (64, 96)
            assert (ma == mb).mean() >= 0.999
            n_masks += int(mb.any())
    assert n_masks > 0, "no masks: the comparison would be empty"
    # --score-gt with JAX's txts as the ground truth: the scores JAX's own
    # scorer gives the same pair (the matched masks are equal: MOTSP 1;
    # the random mask head leaves most masks empty, which match nothing)
    scores = json.load(open(os.path.join(tdir, "mots_scores.json")))
    want = jmots.score_mots_txt(tdir, {"v0": os.path.join(jdir, "v0.txt")},
                                class_id=2)
    assert scores == json.loads(json.dumps(want, default=float))
    assert scores["MOTSP"] == 1.0 and scores["IDsw"] == 0, scores
    assert "sMOTSA=" in capsys.readouterr().out


@pytest.mark.parametrize("mots", [False, True])
def test_track_omni_bdd_matches_jax(setup, monkeypatch, mots):
    """--dataset bdd: the scalabel scores that both tools write."""
    monkeypatch.setenv("UNICORN_DATADIR", setup["data"])
    w = setup["mask" if mots else "track"]
    tag = "seg" if mots else "box"
    jdir, tdir = (str(setup["root"] / f"{k}_bdd_{tag}") for k in "jt")
    extra = ["--dataset", "bdd"] + (["--mots"] if mots else [])
    tc.run_jax_tool("track_omni", _argv(w, "jax", jdir, extra))
    port = tomni.main(_argv(w, "torch", tdir, ["--device", "cpu"] + extra))
    name = "seg_scores.json" if mots else "scores.json"
    ref = json.load(open(os.path.join(jdir, name)))
    assert json.load(open(os.path.join(tdir, name))) == json.loads(
        json.dumps(port, default=float))

    def leaves(d, prefix=""):
        for k, v in sorted(d.items()):
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", v

    got, want = dict(leaves(json.loads(json.dumps(port, default=float)))), \
        dict(leaves(ref))
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.isclose(got[k], want[k], atol=1e-6, rtol=0), (k, got[k],
                                                                want[k])
