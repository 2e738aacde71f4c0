"""The port's cv2-free drawing (unicorn_torch/utils/visualize.py,
debug_dump.py, demo_utils.py), its matplotlib-free OPE plot
(harness/analysis.py plot_results) and its DTI interpolation
(tools/interpolation.py) against OpenCV and the JAX package, on the CPU.

Drawing: images and boxes from numpy seeds, boxes crossing the image's
edges. `rectangle` equals cv2.rectangle (LINE_8) bit for bit at thickness
1, 2, 3 and filled; draw_detections / draw_tracks equal JAX's drawers
everywhere outside each label's cv2.getTextSize box grown by the text's
thickness (the port's label font is not Hershey's; ROADMAP "Standing
disagreements"), and inside a label box the port has drawn pixels of the
label's colour; draw_masks equals JAX's everywhere. dump_uni_batch: the
arrays JAX's writes (cv2.imwrite captured in the JAX module: its files are
JPEGs) against the port's PNGs read back with read_png: the same names and
stems, equal pixels outside the label boxes. Interpolation: the output txts
byte-equal to JAX's tools/interpolation.py.
"""
import importlib.util
import os
import sys
from unittest import mock

import cv2
import numpy as np
import pytest

from unicorn_torch.data.image_io import imread, read_png
from unicorn_torch.harness import analysis as tanalysis
from unicorn_torch.tools import interpolation as tinterp
from unicorn_torch.utils import debug_dump as tdump
from unicorn_torch.utils import demo_utils as tdemo
from unicorn_torch.utils import visualize as tvis
from unicorn_tpu.utils import debug_dump as jdump
from unicorn_tpu.utils import demo_utils as jdemo
from unicorn_tpu.utils import visualize as jvis

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FONT = cv2.FONT_HERSHEY_SIMPLEX


def _label_mask(shape, labels):
    """True inside each (text, org, scale, thickness) label's
    cv2.getTextSize box grown by the thickness."""
    m = np.zeros(shape[:2], bool)
    for text, (x, y), scale, th in labels:
        (w, h), base = cv2.getTextSize(text, FONT, scale, th)
        y0, y1 = max(y - h - th, 0), max(y + base + th + 1, 0)
        x0, x1 = max(x - th, 0), max(x + w + th + 1, 0)
        m[y0:y1, x0:x1] = True
    return m


@pytest.mark.parametrize("thickness", [1, 2, 3, -1])
@pytest.mark.parametrize("seed", range(4))
def test_rectangle_equals_cv2(thickness, seed):
    rng = np.random.RandomState(seed)
    for _ in range(60):
        h, w = rng.randint(4, 80, 2)
        img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        p1 = (int(rng.randint(-30, w + 30)), int(rng.randint(-30, h + 30)))
        p2 = (int(rng.randint(-30, w + 30)), int(rng.randint(-30, h + 30)))
        if rng.rand() < 0.2:
            p2 = (p1[0], p2[1])       # a zero-width box
        color = tuple(int(c) for c in rng.randint(0, 256, 3))
        want = cv2.rectangle(img.copy(), p1, p2, color, thickness)
        got = tvis.rectangle(img.copy(), p1, p2, color, thickness)
        np.testing.assert_array_equal(got, want, err_msg=f"{p1} {p2}")
    gray = np.zeros((20, 30), np.uint8)
    np.testing.assert_array_equal(
        tvis.rectangle(gray.copy(), (3, 4), (25, 30), 200, thickness),
        cv2.rectangle(gray.copy(), (3, 4), (25, 30), 200, thickness))


def _dets(rng, h, w, n):
    x1, y1 = rng.uniform(-25, w, n), rng.uniform(-25, h, n)
    return np.stack([x1, y1, x1 + rng.uniform(1, 90, n),
                     y1 + rng.uniform(1, 90, n), rng.rand(n), rng.rand(n),
                     rng.randint(0, 20, n)], 1).astype(np.float32)


@pytest.mark.parametrize("seed", range(6))
def test_draw_detections_and_tracks_match_jax(seed):
    rng = np.random.RandomState(seed)
    h, w = rng.randint(40, 220, 2)
    img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    dets = _dets(rng, h, w, rng.randint(1, 7))
    names = None if seed % 2 else [f"c{i}" for i in range(20)]
    got = tvis.draw_detections(img, dets, names)
    want = jvis.draw_detections(img, dets, names)
    labels = [(f"{names[int(d[6])] if names else int(d[6])}:"
               f"{float(d[4] * d[5]):.2f}",
               (int(d[0]), max(int(d[1]) - 4, 10)), 0.5, 1) for d in dets]
    outside = ~_label_mask(img.shape, labels)
    np.testing.assert_array_equal(got[outside], want[outside])
    assert (got != img).any()
    tlwh = dets[:, :4].copy()
    tlwh[:, 2:] -= tlwh[:, :2]
    ids = rng.randint(0, 100, len(dets))
    got = tvis.draw_tracks(img, tlwh, ids)
    want = jvis.draw_tracks(img, tlwh, ids)
    labels = [(str(int(t)), (int(x), max(int(y) - 4, 10)), 0.6, 2)
              for (x, y, _, _), t in zip(tlwh, ids)]
    outside = ~_label_mask(img.shape, labels)
    np.testing.assert_array_equal(got[outside], want[outside])
    assert tvis.draw_detections(img, np.zeros((0, 7))).tobytes() == \
        img.tobytes()


@pytest.mark.parametrize("text, scale, thickness", [
    ("0:0.97", 0.5, 1), ("17", 0.6, 2), ("t12c3", 0.4, 1),
    ("person:0.50", 0.5, 1), ("a b~{}|@#$%^&*()_+-=[];',./", 0.5, 1),
    ("café µ", 0.6, 2)])
def test_label_text_in_the_cv2_box_in_the_label_colour(text, scale,
                                                       thickness):
    img = np.zeros((60, 400, 3), np.uint8)
    color = (17, 200, 90)
    org = (20, 40)
    tvis.put_text(img, text, org, scale, color, thickness)
    drawn = img.any(2)
    assert drawn.any()
    assert (img[drawn] == color).all()
    (w, h), base = cv2.getTextSize(text, FONT, scale, thickness)
    inside = np.zeros_like(drawn)
    inside[org[1] - h:org[1] + base + 1, org[0]:org[0] + w + 1] = True
    assert not (drawn & ~inside).any()


def test_label_colour_inside_the_label_box():
    img = np.zeros((100, 200, 3), np.uint8)
    d = np.array([[30, 40, 120, 90, 0.9, 0.8, 3]], np.float32)
    got = tvis.draw_detections(img, d)
    (w, h), base = cv2.getTextSize("3:0.72", FONT, 0.5, 1)
    box = got[36 - h:36 + base + 1, 30:31 + w]
    assert (box == tvis._COLORS[3]).all(2).sum() > 20


def test_draw_masks_matches_jax():
    rng = np.random.RandomState(3)
    img = (rng.rand(37, 53, 3) * 255).astype(np.uint8)
    labels = rng.randint(0, 20, (37, 53))
    for alpha in (0.5, 0.3):
        np.testing.assert_array_equal(tvis.draw_masks(img, labels, alpha),
                                      jvis.draw_masks(img, labels, alpha))


def _uni_batch(seed, masks):
    rng = np.random.RandomState(seed)
    B, H, W, M = 2, 72, 96, 4
    images = rng.rand(B, 2, H, W, 3).astype(np.float32) * 300 - 20
    targets = np.zeros((B, 2, M, 6), np.float32)
    for b in range(B):
        for f in range(2):
            n = rng.randint(1, M + 1)
            wh = rng.uniform(8, 60, (n, 2))
            c = rng.uniform(-5, [W + 5, H + 5], (n, 2))
            targets[b, f, :n] = np.concatenate(
                [rng.randint(0, 3, (n, 1)), c, wh,
                 rng.randint(0, 40, (n, 1))], 1)
    task_ids = np.array([0, 1])
    m = (rng.rand(B, 2, M, H // 4, W // 4) > 0.7).astype(np.float32) \
        if masks else None
    return images, targets, task_ids, m


@pytest.mark.parametrize("masks", [False, True])
def test_dump_uni_batch_matches_jax(tmp_path, masks):
    images, targets, task_ids, m = _uni_batch(5, masks)
    written = {}

    def imwrite(path, img):
        written[os.path.basename(path)] = img.copy()
        return True

    with mock.patch.object(jdump.cv2, "imwrite", imwrite):
        jdump.dump_uni_batch(str(tmp_path / "j"), images, targets, task_ids,
                             masks=m)
    out = tdump.dump_uni_batch(str(tmp_path / "t"), images, targets,
                               task_ids, masks=m)
    names = sorted(os.listdir(out))
    assert [os.path.splitext(n)[0] for n in names] == sorted(
        os.path.splitext(n)[0] for n in written)
    assert all(n.endswith(".png") for n in names)
    for name in names:
        b, f = int(name.split("_")[1][1:]), int(name.split("_")[2][1:])
        want = written[os.path.splitext(name)[0] + ".jpg"]
        got = read_png(os.path.join(out, name))[..., ::-1]
        labels = [(f"t{int(t[5])}c{int(t[0])}",
                   (int(t[1] - t[3] / 2), max(int(t[2] - t[4] / 2) - 3, 10)),
                   0.4, 1) for t in targets[b, f] if t[3] > 0 and t[4] > 0]
        outside = ~_label_mask(want.shape, labels)
        np.testing.assert_array_equal(got[outside], want[outside])


def test_demo_utils(tmp_path):
    rng = np.random.RandomState(0)
    frames = [(rng.rand(24, 32, 3) * 255).astype(np.uint8) for _ in range(3)]
    writer = tdemo.VideoWriter(str(tmp_path / "out"), 12, (32, 24))
    for f in frames:
        writer.write(f)
    writer.release()
    assert sorted(os.listdir(tmp_path / "out")) == [
        "000000.png", "000001.png", "000002.png"]
    (tmp_path / "out" / "notes.txt").write_text("not a frame")
    reader = tdemo.VideoReader(str(tmp_path / "out"), fps=12)
    assert (reader.n_frames, reader.fps, reader.width, reader.height) == (
        3, 12, 32, 24)
    for got, want in zip(reader, frames):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            cv2.imread(str(tmp_path / "out" / "000000.png")), frames[0])
    with pytest.raises(NotImplementedError, match="directory of frames"):
        tdemo.VideoReader(str(tmp_path / "clip.mp4"))
    dets = np.array([[1, 2, 3, 4, 0.5, 0.8, 1], [5, 6, 7, 8, 0.9, 0.1, 0]],
                    np.float32)
    for names in (None, ["a", "b"]):
        assert tdemo.dets_to_json(dets, names) == jdemo.dets_to_json(dets,
                                                                     names)
    assert tdemo.mkdir(str(tmp_path / "x" / "y")) == str(tmp_path / "x" / "y")


def _block_matplotlib(monkeypatch):
    for name in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)


def test_plot_results_without_matplotlib(tmp_path, monkeypatch):
    """The plot's curves pass through plot_pixel of every point of the
    mean success / precision curves, in each tracker's colour, with no
    matplotlib importable."""
    _block_matplotlib(monkeypatch)
    rng = np.random.RandomState(1)
    gts = {f"s{k}": np.tile([20.0 + k, 30.0, 40.0, 30.0], (25, 1))
           for k in range(3)}
    runs = {name: {s: g + rng.randn(*g.shape) * noise
                   for s, g in gts.items()}
            for name, noise in (("a", 3.0), ("b", 12.0))}
    path = tanalysis.plot_results(runs, gts, str(tmp_path / "ope.png"),
                                  title="t")
    img = read_png(path)
    assert img.shape == tanalysis.PLOT_SIZE + (3,)
    for k, results in enumerate(runs.values()):
        color = tvis._COLORS[k]
        sc = np.mean([tanalysis.success_curve(results[s], gts[s])[0]
                      for s in gts], 0)
        pc = np.mean([tanalysis.precision_curve(results[s], gts[s])[0]
                      for s in gts], 0)
        for panel, curve, x_max in ((0, sc, 1.0), (1, pc, 50.0)):
            thr = np.linspace(0, 1, len(curve)) if panel == 0 else \
                np.arange(len(curve))
            hits = 0
            for x, y in zip(thr, curve):
                c, r = tanalysis.plot_pixel(panel, x, y, x_max)
                # a later tracker's curve may cross this one's point
                hits += bool((img[r, c] == color).all())
            assert hits >= len(curve) - 2, (k, panel, hits, len(curve))


def test_analysis_results_plot_without_matplotlib(tmp_path, monkeypatch,
                                                  capsys):
    from unicorn_torch.tools import analysis_results

    _block_matplotlib(monkeypatch)
    seq = tmp_path / "data" / "GOT10K" / "val" / "GOT-10k_Val_000001"
    seq.mkdir(parents=True)
    gt = np.array([[30 + 2 * t, 20, 24, 24] for t in range(3)], float)
    np.savetxt(seq / "groundtruth.txt", gt, delimiter=",")
    for t in range(3):
        cv2.imwrite(str(seq / f"{t + 1:08d}.jpg"), np.zeros((48, 64, 3),
                                                           np.uint8))
    (seq.parent / "list.txt").write_text("GOT-10k_Val_000001\n")
    res = tmp_path / "res"
    res.mkdir()
    np.savetxt(res / "GOT-10k_Val_000001.txt", gt, delimiter="\t")
    monkeypatch.setenv("UNICORN_DATADIR", str(tmp_path / "data"))
    metrics = analysis_results.main(["--dataset", "got10k_val",
                                     "--result-dir", str(res), "--plot",
                                     str(tmp_path / "ope.png")])
    assert metrics["AUC"] == 20 / 21
    assert read_png(str(tmp_path / "ope.png")).shape == \
        tanalysis.PLOT_SIZE + (3,)
    assert "plots saved" in capsys.readouterr().out


def _jax_interpolation():
    spec = importlib.util.spec_from_file_location(
        "jax_interpolation", os.path.join(REPO, "tools", "interpolation.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mot_txt(rng, n_tracks, width):
    rows = []
    for tid in range(1, n_tracks + 1):
        n = rng.randint(1, 40)
        frames = np.sort(rng.choice(np.arange(1, 120), n, replace=False))
        for fr in frames:
            row = [fr, tid, *rng.uniform(0, 500, 4).round(3),
                   round(rng.rand(), 4)]
            rows.append((row + [-1, -1, -1])[:width]
                        if width >= 7 else row[:width])
    return np.array(rows, float)


@pytest.mark.parametrize("width", [10, 7, 6])
@pytest.mark.parametrize("n_min, n_dti", [(25, 20), (3, 5), (0, 60)])
def test_interpolation_byte_equal_to_jax(tmp_path, width, n_min, n_dti):
    """Tracks of 1-39 rows with gaps of every length, so that the gates
    n_min (track length) and n_dti (gap length) fall on both sides; 10
    columns (the MOT format), 7 and 6."""
    jmod = _jax_interpolation()
    rng = np.random.RandomState(width * 100 + n_min)
    src = tmp_path / "in"
    src.mkdir()
    for k in range(3):
        np.savetxt(src / f"MOT17-0{k}-FRCNN.txt",
                   _mot_txt(rng, 6 + k, width), delimiter=",", fmt="%.4f")
    for out, run in (("j", lambda a: jmod.dti(*a, n_min=n_min, n_dti=n_dti)),
                     ("t", lambda a: tinterp.dti(*a, n_min=n_min,
                                                 n_dti=n_dti))):
        os.makedirs(tmp_path / out)
        for f in sorted(os.listdir(src)):
            run((str(src / f), str(tmp_path / out / f)))
    for f in sorted(os.listdir(src)):
        assert (tmp_path / "t" / f).read_bytes() == \
            (tmp_path / "j" / f).read_bytes()
    grew = sum(len((tmp_path / "t" / f).read_text().splitlines())
               - len((src / f).read_text().splitlines())
               for f in os.listdir(src))
    assert (grew > 0) == (n_min < 39 and n_dti > 2)


def test_interpolation_cli_and_copy_1to3(tmp_path):
    jmod = _jax_interpolation()
    rng = np.random.RandomState(0)
    src = tmp_path / "in"
    src.mkdir()
    for name in ("MOT17-02-FRCNN.txt", "MOT17-04-FRCNN.txt", "other.txt"):
        np.savetxt(src / name, _mot_txt(rng, 4, 10), delimiter=",",
                   fmt="%.4f")
    tinterp.main(["--txt-dir", str(src), "--out-dir", str(tmp_path / "t"),
                  "--n-min", "3", "--copy-1to3"])
    with mock.patch.object(sys, "argv", [
            "interpolation.py", "--txt-dir", str(src), "--out-dir",
            str(tmp_path / "j"), "--n-min", "3", "--copy-1to3"]):
        jmod.main()
    for d in ("", "_1to3"):
        t, j = str(tmp_path / "t") + d, str(tmp_path / "j") + d
        names = sorted(os.listdir(t))
        assert names == sorted(os.listdir(j))
        for n in names:
            with open(os.path.join(t, n), "rb") as a, \
                    open(os.path.join(j, n), "rb") as b:
                assert a.read() == b.read()
    assert len(os.listdir(str(tmp_path / "t") + "_1to3")) == 6


def test_imread_of_a_written_frame(tmp_path):
    """VideoWriter's PNGs decode to the frame through the port's reader."""
    f = (np.random.RandomState(2).rand(9, 11, 3) * 255).astype(np.uint8)
    w = tdemo.VideoWriter(str(tmp_path), 30, (11, 9))
    w.write(f)
    np.testing.assert_array_equal(imread(str(tmp_path / "000000.png")), f)
