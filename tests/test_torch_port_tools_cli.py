"""The port's tracking and demo tools (unicorn_torch/tools/track.py,
demo.py) against the JAX package's tools/track.py and tools/demo.py, on
the CPU, with the same weights.

Fixture and exps: tests/test_cli_e2e.py's MOT fixture (one video of six
50x70 JPEG frames, letterboxed to test_size 96x128) and its tiny CSPDarknet
track exp, with one head attention block a level (`n_layer_att = 1`, so
that dw7x7 runs: 3 calls a frame) and the served interaction in fp32; the
port's copy of the exp file imports unicorn_torch's exps. The weights are
the port's seeded init with the obj / cls prediction biases raised by 7
(so that the random detector's scores clear ByteTrack's thresholds), taken
to JAX's tree by convert.to_flax; JAX's tools read them from a JAX
checkpoint (save_checkpoint), the port's from a port checkpoint whose
state_dict is convert.from_flax of the same JAX params.

Tolerances (ROADMAP's MOT parity): the same frame ids and track ids in
every frame; boxes within 1e-2 px, scores within 1e-3 of JAX's. JAX's
results are captured where its tools write them (write_mot_results,
draw_detections patched in the JAX modules for the test only); the port's
tools return theirs, and the txts they write hold the same rows.
"""
import importlib.util
import os
import sys
from unittest import mock

import cv2
import numpy as np
import pytest
import torch

import test_cli_e2e as cli
from unicorn_torch.convert import from_flax, to_flax
from unicorn_torch.exp.base import get_exp
from unicorn_torch.ops import dwconv7x7 as dw
from unicorn_torch.tools import demo as tdemo
from unicorn_torch.tools import track as ttrack

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BIAS_RAISE = 7.0


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def exp_text(base: str, package: str) -> str:
    """tests/test_cli_e2e.py's exp with one head attention block a level
    and an fp32 served interaction, importing `package`'s exps."""
    s = (base.replace("self.n_layer_att = 0", "self.n_layer_att = 1")
         .replace("self.use_attention = False", "self.use_attention = True")
         .replace("self.bf16 = False", "self.bf16 = False\n"
                  "        self.serve_interact_bf16 = False"))
    return s.replace("unicorn_tpu.", package + ".")


def write_weights(root, base_exp, name):
    """Exp files for both packages and one set of weights as a JAX and a
    port checkpoint: {"jax_exp", "torch_exp", "jax_ckpt", "torch_ckpt"}."""
    from unicorn_tpu.core.checkpoint import save_checkpoint

    out = {}
    for pkg, key in (("unicorn_tpu", "jax_exp"), ("unicorn_torch",
                                                  "torch_exp")):
        path = os.path.join(root, f"{name}_{key}.py")
        with open(path, "w") as f:
            f.write(exp_text(base_exp, pkg))
        out[key] = path
    model = get_exp(out["torch_exp"]).get_model(
        torch.Generator().manual_seed(0))
    state = model.state_dict()
    for k in state:
        if k.startswith(("head.obj_preds.", "head.cls_preds.")) and \
                k.endswith(".bias"):
            state[k] = state[k] + BIAS_RAISE
    params = {"params": to_flax(state)}
    save_checkpoint(root, {"params": params}, name=f"{name}_jax")
    out["jax_ckpt"] = os.path.join(root, f"{name}_jax")
    out["torch_ckpt"] = os.path.join(root, f"{name}_torch")
    torch.save({"model": from_flax(params)}, out["torch_ckpt"])
    return out


def run_jax_tool(tool, argv):
    """tools/<tool>.py of the JAX package, run in-process with argv (as
    tests/test_cli_e2e.py runs it)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_cli_{tool}", os.path.join(REPO, "tools", f"{tool}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with mock.patch.object(sys, "argv", [f"{tool}.py"] + list(argv)):
        mod.main()


def captured_mot_results(run):
    """{video: results} that JAX's write_mot_results was handed in run()."""
    from unicorn_tpu.evaluators import mot_evaluator

    got = {}
    real = mot_evaluator.write_mot_results

    def capture(path, results):
        got[os.path.splitext(os.path.basename(path))[0]] = list(results)
        real(path, results)

    with mock.patch.object(mot_evaluator, "write_mot_results", capture):
        run()
    return got


def assert_same_tracks(port, ref):
    """Per video, per frame: equal frame and track ids, boxes within 1e-2
    px, scores within 1e-3."""
    assert sorted(port) == sorted(ref)
    n_tracks = 0
    for video in ref:
        assert len(port[video]) == len(ref[video])
        for (fp, ip, bp, sp), (fr, ir, br, sr) in zip(port[video],
                                                        ref[video]):
            assert fp == fr and [int(i) for i in ip] == [int(i) for i in ir]
            if len(ir):
                np.testing.assert_allclose(np.asarray(bp, np.float64),
                                           np.asarray(br, np.float64),
                                           atol=1e-2, rtol=0)
                np.testing.assert_allclose(np.asarray(sp, np.float64),
                                           np.asarray(sr, np.float64),
                                           atol=1e-3, rtol=0)
            n_tracks += len(ir)
    return n_tracks


def txt_rows(path):
    return np.loadtxt(path, delimiter=",", ndmin=2)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("tools_cli")
    data = str(root / "data")
    cli._write_mot_fixture(data)
    w = write_weights(str(root), cli.TRACK_EXP_SCALED, "track")
    return {"root": root, "data": data, **w}


def _run_track(setup, monkeypatch, tag, extra):
    monkeypatch.setenv("UNICORN_DATADIR", setup["data"])
    jdir, tdir = (str(setup["root"] / f"{k}_{tag}") for k in "jt")
    ref = captured_mot_results(lambda: run_jax_tool("track", [
        "-f", setup["jax_exp"], "-c", setup["jax_ckpt"], "--result-dir",
        jdir, *extra]))
    dw0 = dw.launches
    port = ttrack.main(["-f", setup["torch_exp"], "-c", setup["torch_ckpt"],
                        "--result-dir", tdir, "--device", "cpu", *extra])
    assert dw.launches == dw0   # the CPU runs the plain version
    n = assert_same_tracks(port, ref)
    assert n > 0, "no tracks: the comparison would be empty"
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)) == ["v0.txt"]
    a, b = txt_rows(os.path.join(tdir, "v0.txt")), txt_rows(
        os.path.join(jdir, "v0.txt"))
    assert a.shape == b.shape and np.array_equal(a[:, :2], b[:, :2])
    return port


@pytest.mark.parametrize("tag, extra", [
    ("byte", []),
    ("sort", ["--tracker", "sort"]),
    ("fused", ["--fused", "--chunk", "4", "--track-thresh", "0.3"]),
])
def test_track_matches_jax(setup, monkeypatch, capsys, tag, extra):
    """tools/track.py on the host path (ByteTrack, SORT) and --fused (the
    streaming pipeline, chunks of 4 over 6 frames: the last chunk padded),
    same weights: the same tracks, and the CLEAR-MOT score printed."""
    _run_track(setup, monkeypatch, tag, extra)
    assert "mota" in capsys.readouterr().out.lower()


def test_track_without_checkpoint_uses_seeded_init(setup, monkeypatch,
                                                   tmp_path):
    """Without -c the tool's model is the exp's seed-0 init: the same
    tracks as MOTDriver over that model, run by hand."""
    from unicorn_torch.data.datasets.mot import MOTEvalDataset
    from unicorn_torch.data.transforms import ValTransform
    from unicorn_torch.drivers.mot import MOTDriver
    from unicorn_torch.evaluators.mot_evaluator import (MOTEvaluator,
                                                        mot_step_fn)

    monkeypatch.setenv("UNICORN_DATADIR", setup["data"])
    exp = get_exp(setup["torch_exp"])
    res = ttrack.main(["-f", setup["torch_exp"], "--result-dir",
                       str(tmp_path), "--device", "cpu",
                       "--track-thresh", "0.05"])
    ds = MOTEvalDataset(os.path.join(setup["data"], "mot"), "test_tiny.json",
                        "test", exp.test_size, preproc=ValTransform())
    drv = MOTDriver(exp.get_model(torch.Generator().manual_seed(0)).eval(),
                    exp.test_size, num_classes=1, conf_thre=exp.test_conf,
                    nms_thre=exp.nmsthre, max_out=256, device="cpu")
    ref = MOTEvaluator(exp=exp, dataset=ds, track_thresh=0.05,
                       device="cpu").evaluate(mot_step_fn(drv))
    assert_same_tracks(res, ref)


def _capture_jax_dets(run):
    from unicorn_tpu.utils import visualize

    got = []
    real = visualize.draw_detections

    def capture(img, dets, class_names=None):
        got.append(np.array(dets))
        return real(img, dets, class_names)

    with mock.patch.object(visualize, "draw_detections", capture):
        run()
    return got


def _assert_same_dets(port, ref):
    """The same detections a frame, matched row to row by their boxes (two
    detections whose scores tie to fp32 rounding may come out of the NMS in
    either order): boxes within 1e-2 px, scores within 1e-3, equal
    classes."""
    assert len(port) == len(ref)
    n = 0
    for p, r in zip(port, ref):
        assert p.shape == r.shape
        if len(r):
            dist = np.abs(r[:, None, :4] - p[None, :, :4]).max(-1)
            match = dist.argmin(1)
            assert sorted(match.tolist()) == list(range(len(p)))
            p = p[match]
            np.testing.assert_allclose(p[:, :4], r[:, :4], atol=1e-2, rtol=0)
            np.testing.assert_allclose(p[:, 4] * p[:, 5], r[:, 4] * r[:, 5],
                                       atol=1e-3, rtol=0)
            assert np.array_equal(p[:, 6], r[:, 6])
        n += len(r)
    assert n > 0


def test_demo_image_matches_jax(setup, tmp_path):
    """tools/demo.py image over a directory of two frames: the same
    detections as JAX's (image coordinates), one drawn PNG a frame whose
    pixels outside the boxes' neighbourhood are the frame's."""
    from unicorn_torch.data.image_io import read_png

    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    for name in ("000000.jpg", "000003.jpg"):
        src = os.path.join(setup["data"], "mot", "test", "v0", name)
        cv2.imwrite(str(img_dir / name), cv2.imread(src))
    args = ["-c", None, "--path", str(img_dir), "--conf", "0.3"]
    ref = _capture_jax_dets(lambda: run_jax_tool("demo", [
        "image", "-f", setup["jax_exp"], "--save-dir", str(tmp_path / "j"),
        *[a if a is not None else setup["jax_ckpt"] for a in args]]))
    port = tdemo.main(["image", "-f", setup["torch_exp"], "--save-dir",
                       str(tmp_path / "t"), "--device", "cpu",
                       *[a if a is not None else setup["torch_ckpt"]
                         for a in args]])
    _assert_same_dets(list(port.values()), ref)
    assert sorted(os.listdir(tmp_path / "t")) == ["000000.png", "000003.png"]
    for path, d in port.items():
        stem = os.path.splitext(os.path.basename(path))[0]
        drawn = read_png(str(tmp_path / "t" / f"{stem}.png"))[..., ::-1]
        img = cv2.imread(path)
        assert drawn.shape == img.shape
        changed = (drawn != img).any(2)
        assert changed.any() == (len(d) > 0)


def test_demo_video_matches_jax(setup, tmp_path):
    """tools/demo.py video: JAX reads a clip with cv2.VideoCapture, the port
    the same decoded frames from a directory; the same detections a frame,
    and the drawn frames written as numbered PNGs."""
    frames = [cv2.imread(os.path.join(setup["data"], "mot", "test", "v0",
                                      f"{t:06d}.jpg")) for t in range(4)]
    clip = str(tmp_path / "clip.avi")
    writer = cv2.VideoWriter(clip, cv2.VideoWriter_fourcc(*"MJPG"), 10,
                             (frames[0].shape[1], frames[0].shape[0]))
    for f in frames:
        writer.write(f)
    writer.release()
    cap = cv2.VideoCapture(clip)
    fdir = tmp_path / "frames"
    fdir.mkdir()
    n = 0
    while True:
        ok, f = cap.read()
        if not ok:
            break
        cv2.imwrite(str(fdir / f"{n:04d}.png"), f)
        n += 1
    assert n == 4
    ref = _capture_jax_dets(lambda: run_jax_tool("demo", [
        "video", "-f", setup["jax_exp"], "-c", setup["jax_ckpt"], "--path",
        clip, "--save-dir", str(tmp_path / "j"), "--conf", "0.3"]))
    port = tdemo.main(["video", "-f", setup["torch_exp"], "-c",
                       setup["torch_ckpt"], "--path", str(fdir),
                       "--save-dir", str(tmp_path / "t"), "--conf", "0.3",
                       "--device", "cpu"])
    _assert_same_dets([port[i] for i in range(n)], ref)
    assert sorted(os.listdir(tmp_path / "t" / "demo_out")) == [
        f"{i:06d}.png" for i in range(n)]


def test_demo_refuses_webcam_and_video_files(setup, tmp_path):
    with pytest.raises(NotImplementedError, match="camera"):
        tdemo.main(["webcam", "-f", setup["torch_exp"], "--device", "cpu"])
    clip = tmp_path / "clip.mp4"
    clip.write_bytes(b"\0" * 16)
    with pytest.raises(NotImplementedError, match="directory of frames"):
        tdemo.main(["video", "-f", setup["torch_exp"], "--path", str(clip),
                    "--save-dir", str(tmp_path / "o"), "--device", "cpu"])
