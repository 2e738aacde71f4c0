"""The port's sequence runners and test tool (unicorn_torch/harness/
running.py, unicorn_torch/tools/test.py) against the JAX package's, on the
CPU.

Model: the JAX driver tests' tiny Unicorn (tests/test_drivers.py:14-22:
CSPDarknet depth 0.33 width 0.25, "conv" interaction, no head attention),
for VOS with the mask head and the RAFT up-mask at rate 4
(tests/test_torch_port_vos.py's UNI). Parameters come from the port's
seeded init and reach JAX through unicorn_torch.convert.to_flax. The
frames are 64x64 JPEGs (the input size, so the letterbox and the VOS tail's
resize are the identity), written with cv2 and read by each package with
its own decoder (equal bit for bit).

Cases: run_dataset_sot over a 2-sequence GOT-10k tree (the windowed path,
window 8 over 6 and 7 frames); run_sequence_vos over a 2-sequence DAVIS
tree and a YouTube-VOS sequence whose third frame's annotation adds an
object (add_objects, then the general path); the result txts and PNGs;
tools/test.py end to end on an exp file that defines the tiny model, with
and without a checkpoint, and its --parallel-seqs refusal.

Tolerances, those of the SOT / VOS port tests (tests/test_torch_port_sot.py,
tests/test_torch_port_vos.py): boxes within 1e-2 px of JAX's; the port's
window 8 against window 1 rtol 1e-4, atol 1e-3; label maps equal to JAX's
on at least 99% of each frame's pixels (the VOS tail test's margin, which
may exclude 1% of the pixels: JAX argmaxes (bg, p_1 .. p_K), the port the
odds p / (1 - p), which are monotone in them but round differently).
Written files read back equal to what the runner returned.
"""
import json
import os

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from unicorn_torch.convert import to_flax
from unicorn_torch.data.image_io import read_indexed_mask
from unicorn_torch.drivers.sot import SOTDriver as TSOTDriver
from unicorn_torch.drivers.vos import VOSDriver as TVOSDriver
from unicorn_torch.harness import datasets as tds
from unicorn_torch.harness import running as trun
from unicorn_torch.models.unicorn import Unicorn as TUnicorn
from unicorn_torch.tools import test as ttest
from unicorn_tpu.drivers.sot import SOTDriver as JSOTDriver
from unicorn_tpu.drivers.vos import VOSDriver as JVOSDriver
from unicorn_tpu.harness import datasets as jds
from unicorn_tpu.harness import running as jrun
from unicorn_tpu.models.unicorn import Unicorn as JUnicorn

H = W = 64
TINY = dict(num_classes=1, backbone_name="csp_darknet", depth=0.33,
            width=0.25, in_channels=(256, 512, 1024), interact_mode="conv",
            n_layer_att=0, use_attention=False)
MASK = dict(TINY, use_mask=True, use_raft=True, up_rate=4)
VOS_DRV = dict(conf_thre=0.0, use_raft=True, up_rate=4)
DAVIS_PALETTE = [0, 0, 0, 128, 0, 0, 0, 128, 0, 128, 128, 0, 0, 0, 128] \
    + [0] * (768 - 15)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _frames(rng, n):
    """n frames of a panning smooth texture, 64x64 BGR uint8."""
    base = cv2.resize((rng.rand(16, 16 + 2 * n, 3) * 255).astype(np.uint8),
                      (W + 8 * n, H), interpolation=cv2.INTER_LINEAR)
    return [np.ascontiguousarray(base[:, 8 * t:8 * t + W]) for t in range(n)]


def _write_palette_png(path, m):
    img = Image.fromarray(m, mode="P")
    img.putpalette(DAVIS_PALETTE)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    img.save(path)


def _mask(rects):
    m = np.zeros((H, W), np.uint8)
    for oid, (y0, y1, x0, x1) in rects.items():
        m[y0:y1, x0:x1] = oid
    return m


def _got10k(root, rng):
    names = ["GOT-10k_Val_000002", "GOT-10k_Val_000001"]
    for k, name in enumerate(names):
        sdir = os.path.join(root, "GOT10K", "val", name)
        os.makedirs(sdir)
        frames = _frames(rng, 6 + k)
        for i, f in enumerate(frames):
            cv2.imwrite(os.path.join(sdir, f"{i + 1:08d}.jpg"), f)
        gt = np.tile([14 + 2 * k, 10, 24, 20], (len(frames), 1))
        gt[:, 0] += 4 * np.arange(len(frames))
        np.savetxt(os.path.join(sdir, "groundtruth.txt"), gt, delimiter=",",
                   fmt="%d")
    with open(os.path.join(root, "GOT10K", "val", "list.txt"), "w") as f:
        f.write("\n".join(names) + "\n")


def _davis(root, rng):
    d = os.path.join(root, "DAVIS")
    names = ["bear", "camel"]
    os.makedirs(os.path.join(d, "ImageSets", "2017"))
    with open(os.path.join(d, "ImageSets", "2017", "val.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    for k, name in enumerate(names):
        for t, fr in enumerate(_frames(rng, 4)):
            p = os.path.join(d, "JPEGImages", "480p", name, f"{t:05d}.jpg")
            os.makedirs(os.path.dirname(p), exist_ok=True)
            cv2.imwrite(p, fr)
            rects = {1: (5 + t, 22 + t, 6, 24)}
            if k == 1:
                rects[2] = (30, 46, 28 + 2 * t, 50 + 2 * t)
            _write_palette_png(os.path.join(d, "Annotations", "480p", name,
                                            f"{t:05d}.png"), _mask(rects))


def _ytvos(root, rng):
    v = os.path.join(root, "ytbvos18", "valid")
    name = "0a1b2c3d4e"
    for t, fr in enumerate(_frames(rng, 5)):
        p = os.path.join(v, "JPEGImages", name, f"{5 * t:05d}.jpg")
        os.makedirs(os.path.dirname(p), exist_ok=True)
        cv2.imwrite(p, fr)
    # sparse annotations: object 1 at frame 0, object 3 enters at frame 2
    _write_palette_png(os.path.join(v, "Annotations", name, "00000.png"),
                       _mask({1: (6, 24, 8, 26)}))
    _write_palette_png(os.path.join(v, "Annotations", name, "00010.png"),
                       _mask({1: (8, 26, 8, 26), 3: (34, 50, 30, 52)}))
    with open(os.path.join(v, "meta.json"), "w") as f:
        json.dump({"videos": {name: {"objects": {
            "1": {"frames": ["00000", "00010"]},
            "3": {"frames": ["00010"]}}}}}, f)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("bench"))
    rng = np.random.RandomState(0)
    _got10k(root, rng)
    _davis(root, rng)
    _ytvos(root, rng)
    return root


def _models(cfg, seed):
    tm = TUnicorn(**cfg, generator=torch.Generator().manual_seed(seed))
    return tm.eval(), JUnicorn(**cfg), {"params": to_flax(tm.state_dict())}


@pytest.fixture(scope="module")
def sot_runs(data, tmp_path_factory):
    torch.set_num_threads(1)
    out = tmp_path_factory.mktemp("sot")
    tm, jm, params = _models(TINY, 0)
    seqs = tds.load_got10k(os.path.join(data, "GOT10K", "val"), split="val")
    kw = dict(input_size=(H, W), conf_thre=0.0)
    res = {"seqs": seqs, "out": str(out)}
    res["t"] = trun.run_dataset_sot(
        lambda: TSOTDriver(tm, device="cpu", **kw), seqs, str(out / "t"),
        verbose=False)
    res["j"] = jrun.run_dataset_sot(
        lambda: JSOTDriver(jm, params, **kw), jds.load_got10k(
            os.path.join(data, "GOT10K", "val"), split="val"),
        str(out / "j"), verbose=False)
    res["w1"] = {s.name: trun.run_sequence_sot(
        TSOTDriver(tm, device="cpu", **kw), s, window=1)[0] for s in seqs}
    return res


def test_run_dataset_sot_matches_jax(sot_runs):
    t, j = sot_runs["t"], sot_runs["j"]
    assert list(t) == list(j) == ["GOT-10k_Val_000002", "GOT-10k_Val_000001"]
    for name, seq in zip(t, sot_runs["seqs"]):
        assert t[name].shape == j[name].shape == (len(seq.frames), 4)
        np.testing.assert_array_equal(t[name][0], seq.ground_truth_rect[0])
        np.testing.assert_allclose(t[name], j[name], atol=1e-2)
        assert np.isfinite(t[name]).all() and (t[name][:, 2:] > 0).all()


def test_sot_window_8_equals_window_1(sot_runs):
    for name, boxes in sot_runs["t"].items():
        np.testing.assert_allclose(boxes, sot_runs["w1"][name], rtol=1e-4,
                                   atol=1e-3)


def test_sot_result_txts(sot_runs):
    for name, boxes in sot_runs["t"].items():
        path = os.path.join(sot_runs["out"], "t", f"{name}.txt")
        with open(path) as f:
            first = f.readline()
        assert "\t" in first and "." not in first
        np.testing.assert_array_equal(np.loadtxt(path, delimiter="\t"),
                                      boxes.astype(np.int64))


@pytest.fixture(scope="module")
def vos_runs(data, tmp_path_factory):
    torch.set_num_threads(1)
    out = tmp_path_factory.mktemp("vos")
    tm, jm, params = _models(MASK, 1)
    res = {"out": str(out), "t": {}, "j": {}}
    root = os.path.join(data, "DAVIS")
    seqs = (tds.load_davis(root) + tds.load_ytvos(os.path.join(
        data, "ytbvos18")))
    jseqs = (jds.load_davis(root) + jds.load_ytvos(os.path.join(
        data, "ytbvos18")))
    res["seqs"] = seqs
    jd = JVOSDriver(jm, params, input_size=(H, W), max_objects=2, **VOS_DRV)
    for s, js in zip(seqs, jseqs):
        td = TVOSDriver(tm, input_size=(H, W), max_objects=2, device="cpu",
                        **VOS_DRV)
        res["t"][s.name] = trun.run_sequence_vos(td, s, str(out / "t"))
        res["j"][js.name] = jrun.run_sequence_vos(jd, js, str(out / "j"))
        res.setdefault("ids", {})[s.name] = (list(td.obj_ids),
                                             list(jd.obj_ids))
    return res


def test_run_sequence_vos_matches_jax(vos_runs):
    assert list(vos_runs["t"]) == ["bear", "camel", "0a1b2c3d4e"]
    for s in vos_runs["seqs"]:
        mt, mj = vos_runs["t"][s.name], vos_runs["j"][s.name]
        assert len(mt) == len(mj) == len(s.frames)
        ids_t, ids_j = vos_runs["ids"][s.name]
        assert ids_t == ids_j
        for t, (a, b) in enumerate(zip(mt, mj)):
            assert a.shape == b.shape == (H, W) and a.dtype == np.uint8
            agree = (a == b).mean()
            assert agree >= 0.99, (s.name, t, agree)
        labels = set(np.unique(np.stack(mt)).tolist())
        assert labels <= {0, *ids_t} and len(labels) > 1
    # the entering object takes a slot, and its entry frame shows its
    # annotation verbatim
    assert vos_runs["ids"]["0a1b2c3d4e"][0] == [1, 3]
    entry = read_indexed_mask(vos_runs["seqs"][2].masks[1])
    np.testing.assert_array_equal(vos_runs["t"]["0a1b2c3d4e"][2] == 3,
                                  entry == 3)


def test_vos_pngs_read_back_equal(vos_runs):
    for s in vos_runs["seqs"]:
        for path, m in zip(s.frames, vos_runs["t"][s.name]):
            stem = os.path.splitext(os.path.basename(path))[0]
            png = os.path.join(vos_runs["out"], "t", s.name, stem + ".png")
            np.testing.assert_array_equal(read_indexed_mask(png), m)
            np.testing.assert_array_equal(
                cv2.imread(png, cv2.IMREAD_UNCHANGED), m)


EXP_FILE = """
from unicorn_torch.exp.track import ExpTrack
from unicorn_torch.exp.track_mask import ExpTrackMask

BASE = ExpTrackMask if {mask} else ExpTrack


class Exp(BASE):
    def __init__(self):
        super().__init__()
        self.num_classes = 1
        self.depth, self.width = 0.33, 0.25
        self.backbone_name = "csp_darknet"
        self.in_channels = [256, 512, 1024]
        self.interact_mode = "conv"
        self.use_attention, self.n_layer_att = False, 0
        self.bf16 = self.serve_interact_bf16 = False
        self.test_size = (64, 64)
        if {mask}:
            self.up_rate = 4
"""


def _exp_file(tmp_path, mask):
    path = tmp_path / f"tiny_{'mask' if mask else 'sot'}.py"
    path.write_text(EXP_FILE.format(mask=mask))
    return str(path)


def test_test_tool_sot_end_to_end(data, tmp_path, monkeypatch, sot_runs):
    """tools/test.py unicorn_sot on GOT-10k val: the result txts, the OPE
    scores, and the same boxes as run_dataset_sot on the same model; with
    -c, the checkpoint's EMA weights."""
    monkeypatch.setenv("UNICORN_DATADIR", data)
    exp_file = _exp_file(tmp_path, False)
    args = ["unicorn_sot", "--dataset", "got10k_val", "-f", exp_file,
            "--device", "cpu", "--result-dir", str(tmp_path / "res")]
    out = ttest.main(args)
    from unicorn_torch.exp.base import get_exp
    exp = get_exp(exp_file)
    model = exp.get_model(torch.Generator().manual_seed(0), serve=True)
    seqs = tds.get_dataset("got10k_val")
    ref = trun.run_dataset_sot(
        lambda: TSOTDriver(model, exp.test_size, device="cpu"), seqs,
        verbose=False)
    rdir = tmp_path / "res" / "unicorn_sot" / "got10k_val"
    assert sorted(os.listdir(rdir)) == sorted(f"{s.name}.txt" for s in seqs)
    for s in seqs:
        np.testing.assert_array_equal(out["results"][s.name], ref[s.name])
        assert len(np.loadtxt(rdir / f"{s.name}.txt")) == len(s.frames)
    assert set(out["metrics"]) == {"AUC", "Precision@20", "NormPrecision",
                                   "n_sequences"}
    assert out["metrics"]["n_sequences"] == 2
    # a checkpoint's EMA weights are the ones served
    other = exp.get_model(torch.Generator().manual_seed(5), serve=True)
    torch.save({"ema_model": other.state_dict(), "model": model.state_dict()},
               tmp_path / "ckpt")
    out_c = ttest.main(args + ["-c", str(tmp_path / "ckpt"),
                               "--max-seqs", "1"])
    ref_c = trun.run_sequence_sot(
        TSOTDriver(other, exp.test_size, device="cpu"), seqs[0])[0]
    assert list(out_c["results"]) == [seqs[0].name]
    np.testing.assert_array_equal(out_c["results"][seqs[0].name], ref_c)


def test_test_tool_vos_end_to_end(data, tmp_path, monkeypatch):
    """tools/test.py unicorn_vos on DAVIS 2017 and YouTube-VOS 2018: one PNG
    a frame, equal to the returned label map; J&F over the annotated frames
    (YT-VOS: the two sparse annotations, aligned by stem)."""
    monkeypatch.setenv("UNICORN_DATADIR", data)
    exp_file = _exp_file(tmp_path, True)
    for dataset, n_seqs in (("dv2017", 2), ("yt2018", 1)):
        out = ttest.main(["unicorn_vos", "--dataset", dataset, "-f",
                          exp_file, "--device", "cpu", "--result-dir",
                          str(tmp_path / "res")])
        seqs = tds.get_dataset(dataset)
        assert list(out["preds"]) == [s.name for s in seqs]
        for s in seqs:
            assert len(out["preds"][s.name]) == len(s.frames)
            for path, m in zip(s.frames, out["preds"][s.name]):
                png = (tmp_path / "res" / "unicorn_vos" / dataset / s.name
                       / (os.path.splitext(os.path.basename(path))[0]
                          + ".png"))
                np.testing.assert_array_equal(read_indexed_mask(str(png)), m)
        assert out["metrics"]["n_objects"] == {"dv2017": 3, "yt2018": 0}[
            dataset] and len(seqs) == n_seqs
        assert 0.0 <= out["metrics"]["J&F"] <= 1.0


def test_test_tool_refuses_parallel_seqs(tmp_path):
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        ttest.main(["unicorn_sot", "--dataset", "got10k_val", "-f",
                    _exp_file(tmp_path, False), "--parallel-seqs", "2",
                    "--device", "cpu"])
