"""The port's metric code (unicorn_torch/evaluators: coco_map, voc_eval,
mot_metrics, mots_metrics, bdd_evaluator's scalabel scoring,
MOTEvaluator.score / score_mots) against the JAX package's, on the CPU.

Both packages get the same seeded inputs: COCO bbox and segm results with
crowd and out-of-range ground truth, score ties and false positives; VOC
detections with difficult objects under the 07 and the area metric;
tracking sequences with misses, false positives, identity switches and
ignore regions (CLEAR-MOT, IDF1, HOTA); MOTS masks with class-10 ignore
regions; scalabel box and mask frames with crowd and unscored labels. The
two run the same numpy on the same inputs (the port's RLE IoU and matcher
are native, JAX's too where its library builds), so the result dicts are
equal exactly. The JAX package's own metric cases (tests/test_eval.py,
tests/test_mots.py, tests/test_bdd_e2e.py) run again with the port's
functions in place of JAX's.
"""
import inspect

import numpy as np
import pytest

import test_bdd_e2e as bdd_cases
import test_eval as eval_cases
import test_mots as mots_cases
from unicorn_torch.data.datasets import bdd as tbdd_ds
from unicorn_torch.evaluators import bdd_evaluator as tbdd
from unicorn_torch.evaluators import coco_map as tmap
from unicorn_torch.evaluators import mot_evaluator as tmot
from unicorn_torch.evaluators import mot_metrics as tmm
from unicorn_torch.evaluators import mots_metrics as tmots
from unicorn_torch.evaluators import rle as trle
from unicorn_torch.evaluators import voc_eval as tvoc
from unicorn_tpu.evaluators import bdd_evaluator as jbdd
from unicorn_tpu.evaluators import coco_map as jmap
from unicorn_tpu.evaluators import mot_evaluator as jmot
from unicorn_tpu.evaluators import mot_metrics as jmm
from unicorn_tpu.evaluators import mots_metrics as jmots
from unicorn_tpu.evaluators import voc_eval as jvoc


# ------------------------------------------------------------------ COCO
def coco_case(seed, iou_type="bbox"):
    """(gt dataset, detections): 4 images, categories 1 / 2 / 5, boxes of
    every area range, crowd gts, gts without "area", detections near the
    gts, duplicates, false positives, scores with ties."""
    rng = np.random.RandomState(seed)
    images, anns, dets = [], [], []
    cats = [1, 2, 5]
    aid = 1
    for i in range(4):
        h, w = int(rng.randint(60, 200)), int(rng.randint(60, 260))
        images.append({"id": 10 + i, "height": h, "width": w})
        for _ in range(rng.randint(1, 6)):
            bw = float(rng.choice([6, 20, 45, 110])) * rng.uniform(0.6, 1.4)
            bh = float(rng.choice([6, 20, 45, 110])) * rng.uniform(0.6, 1.4)
            bw, bh = min(bw, w - 2), min(bh, h - 2)
            x, y = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            cat = int(rng.choice(cats))
            crowd = int(rng.rand() < 0.15)
            a = {"id": aid, "image_id": 10 + i, "category_id": cat,
                 "bbox": [x, y, bw, bh], "iscrowd": crowd}
            aid += 1
            m = np.zeros((h, w), np.uint8)
            m[int(y):int(y + bh), int(x):int(x + bw)] = 1
            if iou_type == "segm":
                a["segmentation"] = trle.encode(m)
                a["area"] = float(m.sum())
            elif rng.rand() < 0.7:
                a["area"] = bw * bh
            anns.append(a)
            for _ in range(rng.randint(0, 3)):   # detections near this gt
                j = rng.normal(0, rng.choice([0.5, 3.0, 8.0]), 4)
                bx = [x + j[0], y + j[1], max(bw + j[2], 1.0),
                      max(bh + j[3], 1.0)]
                d = {"image_id": 10 + i, "score": float(
                    np.round(rng.rand(), 1)),
                     "category_id": cat if rng.rand() < 0.9 else
                     int(rng.choice(cats))}
                if iou_type == "segm":
                    dm = np.zeros((h, w), np.uint8)
                    dm[max(int(bx[1]), 0):int(bx[1] + bx[3]),
                       max(int(bx[0]), 0):int(bx[0] + bx[2])] = 1
                    dm ^= (rng.rand(h, w) < 0.01).astype(np.uint8)
                    d["segmentation"] = trle.encode(dm)
                else:
                    d["bbox"] = bx
                dets.append(d)
        for _ in range(rng.randint(0, 3)):       # false positives
            bx = [rng.uniform(0, w / 2), rng.uniform(0, h / 2),
                  rng.uniform(4, w / 2), rng.uniform(4, h / 2)]
            d = {"image_id": 10 + i, "category_id": int(rng.choice(cats)),
                 "score": float(np.round(rng.rand(), 1))}
            if iou_type == "segm":
                dm = np.zeros((h, w), np.uint8)
                dm[int(bx[1]):int(bx[1] + bx[3]),
                   int(bx[0]):int(bx[0] + bx[2])] = 1
                d["segmentation"] = trle.encode(dm)
            else:
                d["bbox"] = bx
            dets.append(d)
    gt = {"images": images, "annotations": anns,
          "categories": [{"id": c, "name": str(c)} for c in cats]}
    return gt, dets


def _copy_gt(gt):
    return {k: [dict(x) for x in v] for k, v in gt.items()}


@pytest.mark.parametrize("iou_type", ["bbox", "segm"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coco_map_matches_jax(iou_type, seed):
    gt, dets = coco_case(seed, iou_type)
    got = tmap.COCOMeanAP(_copy_gt(gt), iou_type).evaluate(
        [dict(d) for d in dets])
    want = jmap.COCOMeanAP(_copy_gt(gt), iou_type).evaluate(
        [dict(d) for d in dets])
    assert got == want
    assert got["AP"] > 0 and got["AP"] < 1
    ids = [im["id"] for im in gt["images"][:2]]
    assert tmap.COCOMeanAP(_copy_gt(gt), iou_type).evaluate(
        [dict(d) for d in dets], ids) == jmap.COCOMeanAP(
        _copy_gt(gt), iou_type).evaluate([dict(d) for d in dets], ids)


# ------------------------------------------------------------------- VOC
def voc_case(seed):
    rng = np.random.RandomState(seed)
    all_gts, all_dets = {}, {}
    for c in range(4):
        gts, dets = {}, []
        for img in range(6):
            n = rng.randint(0, 4)
            xy = rng.uniform(0, 200, (n, 2))
            boxes = np.concatenate([xy, xy + rng.uniform(10, 80, (n, 2))], 1)
            gts[img] = (boxes, rng.rand(n) < 0.2)
            for b in boxes:
                for _ in range(rng.randint(0, 3)):
                    j = b + rng.normal(0, 6, 4)
                    dets.append((img, float(np.round(rng.rand(), 2)), *j))
            for _ in range(rng.randint(0, 2)):
                xy = rng.uniform(0, 200, 2)
                dets.append((int(rng.randint(0, 8)), float(rng.rand()),
                             *xy, *(xy + 30)))
        all_gts[c] = gts
        all_dets[c] = dets
    return all_dets, all_gts


@pytest.mark.parametrize("use_07", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_voc_map_matches_jax(use_07, seed):
    dets, gts = voc_case(seed)
    for thr in (0.5, 0.7):
        got = tvoc.voc_map(dets, gts, iou_thr=thr, use_07_metric=use_07)
        assert got == jvoc.voc_map(dets, gts, iou_thr=thr,
                                   use_07_metric=use_07)
        assert 0 < got["mAP"] < 1


# ------------------------------------------------------- CLEAR-MOT, HOTA
def mot_case(seed, n_videos=2, n_frames=12, ignore=True):
    """(results, gts) as MOTEvaluator.score takes them: moving objects,
    missed and jittered detections, clutter, id switches, per-frame ignore
    boxes with a prediction on them."""
    rng = np.random.RandomState(seed)
    results, gts = {}, {}
    for v in range(n_videos):
        n = rng.randint(2, 6)
        pos = rng.uniform(0, 300, (n, 2))
        vel = rng.uniform(-4, 4, (n, 2))
        size = rng.uniform(15, 60, (n, 2))
        hyp_id = {i: 100 + i for i in range(n)}
        res_frames, gt_frames = [], []
        for f in range(1, n_frames + 1):
            g_ids, g_tlwh, h_ids, h_tlwh = [], [], [], []
            for i in range(n):
                tl = pos[i] + f * vel[i]
                g_ids.append(i + 1)
                g_tlwh.append((*tl, *size[i]))
                if rng.rand() < 0.15:
                    continue                      # missed
                if rng.rand() < 0.05:
                    hyp_id[i] = 200 + int(rng.randint(0, 50))  # id switch
                h_ids.append(hyp_id[i])
                h_tlwh.append((*(tl + rng.normal(0, 2, 2)),
                               *(size[i] + rng.normal(0, 2, 2))))
            for _ in range(rng.randint(0, 2)):    # clutter
                h_ids.append(900 + int(rng.randint(0, 20)))
                h_tlwh.append((*rng.uniform(0, 300, 2),
                               *rng.uniform(10, 40, 2)))
            ign = []
            if ignore and rng.rand() < 0.5:
                ign = [(400.0, 400.0, 30.0, 30.0)]
                h_ids.append(990)
                h_tlwh.append((401.0, 399.0, 30.0, 31.0))
            res_frames.append((f, h_ids, h_tlwh, [0.9] * len(h_ids)))
            gt_frames.append((f, g_ids, g_tlwh, ign) if ign else
                             (f, g_ids, g_tlwh))
        results[f"v{v}"] = res_frames
        gts[f"v{v}"] = gt_frames
    return results, gts


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_clear_mot_and_hota_match_jax(seed):
    results, gts = mot_case(seed)
    got = tmot.MOTEvaluator.score(results, gts)
    assert got == jmot.MOTEvaluator.score(results, gts)
    assert {"MOTA", "IDF1", "HOTA", "DetA", "AssA"} <= set(got)
    for v, frames in results.items():
        acc_t, acc_j = tmm.MOTAccumulator(), jmm.MOTAccumulator()
        for (f, ids, tlwh, _), g in zip(frames, gts[v]):
            gb = [(x, y, x + w, y + h) for x, y, w, h in g[2]]
            hb = [(x, y, x + w, y + h) for x, y, w, h in tlwh]
            acc_t.update(g[1], gb, ids, hb)
            acc_j.update(g[1], gb, ids, hb)
        assert acc_t.metrics() == acc_j.metrics()
    pred = {f: (ids, [(x, y, x + w, y + h) for x, y, w, h in tlwh])
            for f, ids, tlwh, _ in results["v0"]}
    gtd = {g[0]: (g[1], [(x, y, x + w, y + h) for x, y, w, h in g[2]])
           for g in gts["v0"]}
    assert tmm.hota(gtd, pred) == jmm.hota(gtd, pred)


# ------------------------------------------------------------------ MOTS
def mots_case(seed, n_frames=6, with_class=False, ignore=False):
    """{video: [(frame, ids[, classes], rles[, ignore rles])]} for gts and
    predictions: rectangles with jitter, misses, a swapped id, a
    prediction inside an ignore region."""
    rng = np.random.RandomState(seed)
    h, w = 40, 56
    gts, preds = {}, {}
    for v in range(2):
        n = rng.randint(2, 4)
        tl = rng.randint(0, 20, (n, 2))
        cls = rng.randint(0, 3, n)
        gv, pv = [], []
        for f in range(n_frames):
            g_ids, g_c, g_r, p_ids, p_c, p_r = [], [], [], [], [], []
            for i in range(n):
                y, x = tl[i] + f
                m = np.zeros((h, w), np.uint8)
                m[y:y + 12, x:x + 14] = 1
                g_ids.append(i + 1)
                g_c.append(int(cls[i]))
                g_r.append(trle.encode(m))
                if rng.rand() < 0.2:
                    continue
                pm = np.roll(m, tuple(rng.randint(-2, 3, 2)), (0, 1))
                pm ^= (rng.rand(h, w) < 0.02).astype(np.uint8)
                p_ids.append(50 + i if f < 4 or i else 77)
                p_c.append(int(cls[i]))
                p_r.append(trle.encode(pm))
            ign = []
            if ignore:
                im = np.zeros((h, w), np.uint8)
                im[30:40, 40:56] = 1
                ign = [trle.encode(im)]
                gm = np.zeros((h, w), np.uint8)
                gm[32:38, 44:52] = 1
                p_ids.append(99)
                p_c.append(0)
                p_r.append(trle.encode(gm))
            if with_class:
                gv.append((f, g_ids, g_c, g_r))
                pv.append((f, p_ids, p_c, p_r))
            else:
                gv.append((f, g_ids, g_r, ign) if ignore else
                          (f, g_ids, g_r))
                pv.append((f, p_ids, p_r))
        gts[f"v{v}"] = gv
        preds[f"v{v}"] = pv
    return preds, gts


@pytest.mark.parametrize("seed", [0, 1])
def test_mots_scores_match_jax(seed, tmp_path):
    preds, gts = mots_case(seed, ignore=True)
    assert tmots.score_mots(preds, gts) == jmots.score_mots(preds, gts)
    preds, gts = mots_case(seed, with_class=True)
    got = tmots.score_mots_per_class(preds, gts)
    assert got == jmots.score_mots_per_class(preds, gts)
    assert got["per_class"]
    # the txt round trip: written by the port, scored by both
    gt_txt = {}
    for v, frames in gts.items():
        tmots.write_mots_txt(str(tmp_path / "gt" / f"{v}.txt"),
                             [(f, [2000 + i for i in ids], [2] * len(ids),
                               r) for f, ids, _, r in frames])
        tmots.write_mots_txt(str(tmp_path / "res" / f"{v}.txt"),
                             [(f, [2000 + i for i in ids], [2] * len(ids),
                               r) for f, ids, _, r in preds[v]])
        gt_txt[v] = str(tmp_path / "gt" / f"{v}.txt")
        assert tmots.load_mots_txt(gt_txt[v]) == jmots.load_mots_txt(
            gt_txt[v])
    assert tmots.score_mots_txt(str(tmp_path / "res"), gt_txt, class_id=2) \
        == jmots.score_mots_txt(str(tmp_path / "res"), gt_txt, class_id=2)


# -------------------------------------------------------------- scalabel
def scalabel_case(seed, masks=False):
    """(pred frames, gt frames): 2 videos x 5 frames, 8 classes' names,
    unscored categories, crowd labels, misses and clutter."""
    rng = np.random.RandomState(seed)
    h, w = 40, 64
    cats = list(tbdd.BDD_CLASSES) + ["other person", "trailer"]
    gt, pred = [], []
    for v in range(2):
        n = 5
        tl = rng.uniform(0, 30, (n, 2))
        cat = [cats[int(rng.randint(0, len(cats)))] for _ in range(n)]
        crowd = rng.rand(n) < 0.15
        for f in range(5):
            gl, pl = [], []
            for i in range(n):
                x, y = tl[i] + f
                box = {"x1": float(x), "y1": float(y), "x2": float(x + 20),
                       "y2": float(y + 12)}
                lab = {"id": i + 1, "category": cat[i], "box2d": box}
                if crowd[i]:
                    lab["attributes"] = {"crowd": True}
                m = np.zeros((h, w), np.uint8)
                m[int(y):int(y) + 12, int(x):int(x) + 20] = 1
                if masks:
                    lab["rle"] = trle.encode(m)
                gl.append(lab)
                if rng.rand() < 0.2 or cat[i] not in tbdd.BDD_CLASSES:
                    continue
                j = rng.normal(0, 1.5, 4)
                pb = {"x1": box["x1"] + j[0], "y1": box["y1"] + j[1],
                      "x2": box["x2"] + j[2], "y2": box["y2"] + j[3]}
                plab = {"id": 100 + i if f < 3 else 200 + i,
                        "category": cat[i], "box2d": pb}
                if masks:
                    plab["rle"] = trle.encode(np.roll(m, 1, 1))
                pl.append(plab)
            if rng.rand() < 0.5:
                cm = np.zeros((h, w), np.uint8)
                cm[30:38, 50:60] = 1
                pl.append({"id": 500, "category": "car",
                           "box2d": {"x1": 50.0, "y1": 30.0, "x2": 60.0,
                                     "y2": 38.0}, "rle": trle.encode(cm)})
            gt.append({"videoName": f"v{v}", "frameIndex": f, "labels": gl})
            pred.append({"videoName": f"v{v}", "frameIndex": f,
                         "labels": pl})
    return pred, gt


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scalabel_det_and_seg_scores_match_jax(seed):
    pred, gt = scalabel_case(seed)
    got = tbdd.score_scalabel(pred, gt)
    assert got == jbdd.score_scalabel(pred, gt)
    assert got["per_class"]
    pred, gt = scalabel_case(seed, masks=True)
    got = tbdd.score_scalabel_seg(pred, gt)
    assert got == jbdd.score_scalabel_seg(pred, gt)


# -------------------------------------- the JAX package's cases, re-run
EVAL_CASES = ["test_coco_map_perfect", "test_coco_map_miss_and_fp",
              "test_coco_map_localization_quality", "test_rle_roundtrip",
              "test_rle_iou", "test_hota_perfect_tracking",
              "test_hota_id_switch_halfway",
              "test_hota_missed_and_false_detections",
              "test_hota_score_pools_videos_with_namespaced_ids",
              "test_score_suppresses_predictions_on_ignore_regions"]


@pytest.mark.parametrize("case", EVAL_CASES)
def test_jax_eval_cases_on_the_port(case, monkeypatch):
    """tests/test_eval.py's case with the port's COCOMeanAP, RLE codec,
    hota and MOTEvaluator in place of JAX's."""
    monkeypatch.setattr(eval_cases, "COCOMeanAP", tmap.COCOMeanAP)
    monkeypatch.setattr(eval_cases, "rle", trle)
    monkeypatch.setattr(jmm, "hota", tmm.hota)
    monkeypatch.setattr(jmot, "MOTEvaluator", tmot.MOTEvaluator)
    getattr(eval_cases, case)()


MOTS_CASES = ["test_mask_iou_matrix_exact", "test_score_mots_golden_values",
              "test_score_mots_soft_tp_credit",
              "test_score_mots_fp_on_gt_empty_frame",
              "test_score_mots_per_class_fp_without_class_gt",
              "test_score_mots_per_class_mmotsa", "test_mots_txt_roundtrip",
              "test_score_mots_txt_equals_direct",
              "test_merge_mots_masks_ascending_id_priority",
              "test_merge_mots_masks_resizes_to_original_resolution",
              "test_write_bdd_bitmask_encoding",
              "test_score_scalabel_seg_golden",
              "test_score_mots_txt_class10_ignore_regions",
              "test_score_scalabel_seg_crowd_ignore_regions"]


def patch_mots_cases(monkeypatch):
    """tests/test_mots.py's imports, and the JAX modules its cases import
    from inside, pointed at the port's."""
    for name in ("load_mots_txt", "mask_iou_matrix", "score_mots",
                 "score_mots_per_class", "score_mots_txt", "write_mots_txt"):
        monkeypatch.setattr(mots_cases, name, getattr(tmots, name))
        monkeypatch.setattr(jmots, name, getattr(tmots, name))
    monkeypatch.setattr(mots_cases, "rle_codec", trle)
    monkeypatch.setattr(mots_cases, "merge_mots_masks",
                        tmot.merge_mots_masks)
    for name in ("write_bdd_bitmask", "score_scalabel_seg"):
        monkeypatch.setattr(jbdd, name, getattr(tbdd, name))


@pytest.mark.parametrize("case", MOTS_CASES)
def test_jax_mots_cases_on_the_port(case, monkeypatch, tmp_path):
    """tests/test_mots.py's scoring, txt, merge and bitmask case on the
    port's functions."""
    patch_mots_cases(monkeypatch)
    fn = getattr(mots_cases, case)
    if "tmp_path" in inspect.signature(fn).parameters:
        fn(tmp_path)
    else:
        fn()


def test_jax_score_scalabel_case_on_the_port(monkeypatch, tmp_path):
    """tests/test_bdd_e2e.py's score_scalabel case (perfect, ignore-region
    and degraded predictions) on the port's scoring and scalabel loader."""
    monkeypatch.setattr(bdd_cases, "score_scalabel", tbdd.score_scalabel)
    monkeypatch.setattr(bdd_cases, "load_scalabel", tbdd_ds.load_scalabel)
    monkeypatch.setattr(bdd_cases, "BDD_CLASSES", tbdd_ds.BDD_CLASSES)
    bdd_cases.test_score_scalabel_perfect_and_degraded(
        bdd_cases._make_fixture(str(tmp_path)))
