"""The port's benchmark scores and packers (unicorn_torch/harness/
davis_metrics.py, analysis.py, submission.py, tools/analysis_results.py)
against OpenCV and the JAX package's, on the CPU.

Equality is exact: `ellipse_kernel(k)` is cv2's MORPH_ELLIPSE element for
every odd k from 3 to 61; `dilate` is cv2.dilate bit for bit on seeded
random masks (sparse and dense, touching the border) at 40x50 and 480x854
(DAVIS, whose boundary kernel is 17x17); jaccard, boundary_f,
evaluate_davis (with objects entering mid-video), the success / precision
curves and evaluate_sot equal JAX's float for float (the same numpy
arithmetic on the same masks). The GOT-10k / TrackingNet zips hold the
same member names with the same bytes. JAX's own DAVIS cases
(tests/test_eval.py::test_davis_*) run again on the port.
"""
import os
import zipfile

import cv2
import numpy as np
import pytest

import test_eval as eval_cases
from unicorn_torch.harness import analysis as tan
from unicorn_torch.harness import davis_metrics as tdm
from unicorn_torch.harness import submission as tsub
from unicorn_torch.tools import analysis_results
from unicorn_tpu.harness import analysis as jan
from unicorn_tpu.harness import datasets as jds
from unicorn_tpu.harness import davis_metrics as jdm
from unicorn_tpu.harness import submission as jsub


@pytest.mark.parametrize("k", range(3, 62, 2))
def test_ellipse_kernel_equals_cv2(k):
    ref = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (k, k))
    got = tdm.ellipse_kernel(k)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)


def _random_mask(rng, shape):
    """Sparse speckle or dense blobs, with pixels on the border rows and
    columns."""
    h, w = shape
    m = rng.rand(h, w) < rng.choice([0.002, 0.05, 0.5])
    for _ in range(rng.randint(1, 4)):
        y, x = rng.randint(0, h), rng.randint(0, w)
        m[y:y + rng.randint(1, h), x:x + rng.randint(1, w)] = True
    m[0] |= rng.rand(w) < 0.2
    m[-1] |= rng.rand(w) < 0.2
    m[:, 0] |= rng.rand(h) < 0.2
    m[:, -1] |= rng.rand(h) < 0.2
    return m


@pytest.mark.parametrize("shape", [(40, 50), (480, 854)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dilate_equals_cv2(shape, seed):
    rng = np.random.RandomState(seed)
    bound_pix = int(np.ceil(0.008 * np.linalg.norm(shape)))
    sizes = {2 * bound_pix + 1, 3, 17, 61} if shape[0] < 100 else \
        {2 * bound_pix + 1}
    assert shape[0] < 100 or bound_pix == 8
    for k in sorted(sizes):
        kernel = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (k, k))
        for _ in range(3):
            m = _random_mask(rng, shape)
            ref = cv2.dilate(m.astype(np.uint8), kernel) > 0
            np.testing.assert_array_equal(tdm.dilate(m, kernel), ref)
    # a kernel that is not symmetric, with two runs in a row
    kernel = np.array([[1, 0, 1, 1], [0, 1, 1, 0], [1, 1, 0, 0]], np.uint8)
    m = _random_mask(rng, shape)
    np.testing.assert_array_equal(
        tdm.dilate(m, kernel), cv2.dilate(m.astype(np.uint8), kernel) > 0)


def _blob_pair(rng, shape):
    h, w = shape
    g = np.zeros(shape, bool)
    y, x = rng.randint(0, h // 2), rng.randint(0, w // 2)
    g[y:y + rng.randint(1, h // 2), x:x + rng.randint(1, w // 2)] = True
    p = np.roll(g, (rng.randint(-6, 7), rng.randint(-6, 7)), (0, 1))
    p ^= rng.rand(*shape) < 0.01
    return p, g


@pytest.mark.parametrize("shape", [(40, 50), (480, 854)])
def test_jaccard_and_boundary_f_equal_jax(shape):
    rng = np.random.RandomState(3)
    pairs = [_blob_pair(rng, shape) for _ in range(4)]
    empty, full = np.zeros(shape, bool), np.ones(shape, bool)
    pairs += [(empty, empty), (empty, pairs[0][1]), (full, full),
              (full, pairs[0][1]), (_random_mask(rng, shape), pairs[1][1])]
    for p, g in pairs:
        assert tdm.jaccard(p, g) == jdm.jaccard(p, g)
        assert tdm.boundary_f(p, g) == jdm.boundary_f(p, g)
        np.testing.assert_array_equal(tdm._seg2bmap(p), jdm._seg2bmap(p))


def _video(rng, T, shape, entries):
    """T frames of indexed masks; object oid enters at frame entries[oid]."""
    gts, preds = [], []
    h, w = shape
    for t in range(T):
        g = np.zeros(shape, np.uint8)
        for oid, t0 in entries.items():
            if t >= t0:
                y, x = 4 * oid + t, 5 * oid + 2 * t
                g[y % (h - 12):y % (h - 12) + 12, x % (w - 15):
                  x % (w - 15) + 15] = oid
        p = np.roll(g, rng.randint(-2, 3), axis=1)
        p[rng.rand(*shape) < 0.02] = 0
        gts.append(g)
        preds.append(p)
    return preds, gts


@pytest.mark.parametrize("skip", [True, False])
def test_evaluate_davis_equals_jax(skip):
    rng = np.random.RandomState(4)
    preds, gts = {}, {}
    preds["a"], gts["a"] = _video(rng, 6, (40, 50), {1: 0, 2: 0})
    preds["b"], gts["b"] = _video(rng, 7, (48, 64), {1: 0, 3: 2, 5: 4})
    preds["c"], gts["c"] = _video(rng, 2, (40, 50), {1: 0})
    preds["d"] = preds["a"]            # no ground truth: not scored
    got = tdm.evaluate_davis(preds, gts, skip_first_last=skip)
    assert got == jdm.evaluate_davis(preds, gts, skip_first_last=skip)
    assert got["n_objects"] == (5 if skip else 6) and 0 < got["J&F"] < 1
    perfect = tdm.evaluate_davis(gts, gts)
    assert perfect["J&F"] == 1.0 and perfect["n_objects"] == 5


CASES = [n for n in dir(eval_cases) if n.startswith("test_davis_")]


@pytest.mark.parametrize("case", CASES)
def test_jax_davis_cases_on_the_port(case, monkeypatch):
    """tests/test_eval.py's DAVIS cases, which import the metrics inside the
    function: the port's patched into the JAX module, for this test only."""
    for name in ("jaccard", "boundary_f", "evaluate_davis"):
        monkeypatch.setattr(jdm, name, getattr(tdm, name))
    getattr(eval_cases, case)()


def _tracks(rng, n):
    gt = np.column_stack([rng.rand(n, 2) * 300, 20 + rng.rand(n, 2) * 80])
    gt[rng.rand(n) < 0.1, 2:] = 0          # absent frames: not scored
    pred = gt + rng.randn(n, 4) * rng.choice([1.0, 8.0, 40.0])
    return pred, gt


def test_curves_and_evaluate_sot_equal_jax():
    rng = np.random.RandomState(5)
    results, gts = {}, {}
    for k in range(4):
        results[f"s{k}"], gts[f"s{k}"] = _tracks(rng, 30 + 7 * k)
    results["s0"] = results["s0"][:20]      # a short result is cut to match
    results["extra"] = results["s1"]        # no ground truth: not scored
    for name in gts:
        p, g = results[name], gts[name]
        n = min(len(p), len(g))
        for fn in ("success_curve", "precision_curve",
                   "normalized_precision_curve"):
            ct, tt = getattr(tan, fn)(p[:n], g[:n])
            cj, tj = getattr(jan, fn)(p[:n], g[:n])
            np.testing.assert_array_equal(ct, cj)
            np.testing.assert_array_equal(tt, tj)
        np.testing.assert_array_equal(tan._iou_xywh(p[:n], g[:n]),
                                      jan._iou_xywh(p[:n], g[:n]))
    got = tan.evaluate_sot(results, gts)
    assert got == jan.evaluate_sot(results, gts)
    assert got["n_sequences"] == 4
    assert tan.evaluate_sot({}, gts) == jan.evaluate_sot({}, gts)
    # integer ground truth fed back as the prediction: every IoU is exactly
    # 1, above 20 of the 21 thresholds (with fractional boxes, rounding in
    # the corners can put an IoU one ulp above 1)
    gts = {k: np.round(v) for k, v in gts.items()}
    exact = tan.evaluate_sot(gts, gts)
    assert exact["AUC"] == 20 / 21 and exact["Precision@20"] == 1.0


def _zip_members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


@pytest.mark.parametrize("packer", ["transform_got10k",
                                    "transform_trackingnet"])
def test_submission_zips_equal_jax(tmp_path, packer):
    rng = np.random.RandomState(6)
    res = tmp_path / "results"
    res.mkdir()
    for k in range(3):
        boxes = np.round(rng.rand(5 + k, 4) * 200)
        np.savetxt(res / f"seq_{k}.txt", boxes, delimiter="\t", fmt="%d")
    np.savetxt(res / "seq_0_time.txt", np.full(5, 0.03), fmt="%.6f")
    zt = getattr(tsub, packer)(str(res), str(tmp_path / "t"))
    zj = getattr(jsub, packer)(str(res), str(tmp_path / "j"))
    assert os.path.basename(zt) == os.path.basename(zj)
    mt, mj = _zip_members(zt), _zip_members(zj)
    assert sorted(mt) == sorted(mj) and len(mt) >= 3
    for name in mt:
        assert mt[name] == mj[name], name
        delim = None if name.endswith("_time.txt") else ","
        np.testing.assert_array_equal(
            np.loadtxt(mt[name].decode().splitlines(), delimiter=delim),
            np.loadtxt(mj[name].decode().splitlines(), delimiter=delim))


def _got10k_tree(root, rng):
    names = ["GOT-10k_Val_000001", "GOT-10k_Val_000002"]
    res = os.path.join(root, "res")
    os.makedirs(res)
    for k, name in enumerate(names):
        sdir = os.path.join(root, "GOT10K", "val", name)
        os.makedirs(sdir)
        pred, gt = _tracks(rng, 12 + k)
        np.savetxt(os.path.join(sdir, "groundtruth.txt"), gt, delimiter=",")
        np.savetxt(os.path.join(res, f"{name}.txt"), pred, delimiter="\t",
                   fmt="%d")
        for i in range(len(gt)):
            open(os.path.join(sdir, f"{i + 1:08d}.jpg"), "wb").close()
    with open(os.path.join(root, "GOT10K", "val", "list.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    return res


def test_analysis_results_cli_and_plot(tmp_path, monkeypatch):
    res = _got10k_tree(str(tmp_path), np.random.RandomState(7))
    monkeypatch.setenv("UNICORN_DATADIR", str(tmp_path))
    png = tmp_path / "plots" / "ope.png"
    png.parent.mkdir()
    metrics = analysis_results.main(["--dataset", "got10k_val",
                                     "--result-dir", res, "--plot", str(png)])
    gts = {s.name: s.ground_truth_rect
           for s in jds.get_dataset("got10k_val")}
    results = {f[:-4]: np.loadtxt(os.path.join(res, f), delimiter="\t")
               for f in os.listdir(res)}
    assert metrics == jan.evaluate_sot(results, gts)
    assert metrics["n_sequences"] == 2
    with open(png, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    assert tan.plot_results({"a": results}, gts, str(tmp_path / "p.png")) \
        == str(tmp_path / "p.png")
