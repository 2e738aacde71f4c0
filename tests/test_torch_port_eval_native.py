"""The port's native evaluator codecs (unicorn_torch/csrc/rle.cpp and
cocoeval.cpp through csrc/native.py) against their plain numpy / Python
forms (evaluators/rle.py's *_plain, coco_map.match_plain) and against the
JAX package's, on the CPU.

Equality is bit for bit: counts, strings, masks, merges, areas, the IoU
matrices' float64 bits (both forms count the intersection in integers and
divide once), evaluate_img's matches and ignore flags. The masks are
seeded: blocks with speckle, all zeros, all ones, single rows and columns,
and masks whose runs cross the column boundary. The cases of JAX's
tests/test_native.py run again with the port's codec and matcher.
"""
import numpy as np
import pytest

import test_native as jax_native_cases
from unicorn_torch.csrc import build, native
from unicorn_torch.evaluators import coco_map as tmap
from unicorn_torch.evaluators import rle as trle
from unicorn_tpu.evaluators import coco_map as jmap
from unicorn_tpu.evaluators import rle as jrle


def _masks(seed, n=12):
    rng = np.random.RandomState(seed)
    out = [np.zeros((7, 11), np.uint8), np.ones((7, 11), np.uint8),
           np.ones((1, 9), np.uint8), (rng.rand(9, 1) < 0.5).astype(np.uint8)]
    for _ in range(n):
        h, w = rng.randint(1, 48, 2)
        m = np.zeros((h, w), np.uint8)
        for _b in range(rng.randint(1, 4)):
            y, x = rng.randint(0, h), rng.randint(0, w)
            m[y:y + rng.randint(1, h + 1), x:x + rng.randint(1, w + 1)] = 1
        m ^= (rng.rand(h, w) < rng.choice([0.0, 0.02, 0.5])).astype(np.uint8)
        out.append(m)
    return out


def _bits_equal(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.int64), b.view(np.int64))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rle_codec_native_equals_plain_bit_for_bit(seed):
    masks = _masks(seed)
    for m in masks:
        c = trle.encode_counts(m)
        assert c == trle.encode_counts_plain(m) == jrle.encode_counts(m)
        s = trle.compress(c)
        assert s == trle.compress_plain(c) == jrle.compress(c)
        assert trle.decompress(s) == trle.decompress_plain(s) == c
        for form in (c, s, {"size": s["size"],
                            "counts": s["counts"].encode("ascii")}):
            d = trle.decode(form)
            assert d.dtype == np.uint8
            np.testing.assert_array_equal(d, trle.decode_plain(form))
            np.testing.assert_array_equal(d, m)
            assert trle.area(form) == trle.area_plain(form) == int(m.sum())
    rng = np.random.RandomState(seed + 10)
    for _ in range(4):
        h, w = rng.randint(1, 30, 2)
        group = [trle.encode(np.asarray(rng.rand(h, w) < p, np.uint8))
                 for p in rng.rand(rng.randint(1, 4))]
        for inter in (False, True):
            got = trle.merge(group, inter)
            assert got == trle.merge_plain(group, inter) == \
                jrle.merge(group, inter)
        d = group + [trle.encode(np.zeros((h, w), np.uint8))]
        g = list(reversed(group))
        for crowd in (None, [k % 2 for k in range(len(g))]):
            iou = trle.iou_rle(d, g, crowd)
            _bits_equal(iou, trle.iou_rle_plain(d, g, crowd))
            _bits_equal(iou, jrle.iou_rle(d, g, crowd))
    assert trle.iou_rle([], g).shape == (0, len(g))
    assert trle.iou_rle_plain(d, []).shape == (len(d), 0)


def test_rle_native_refuses_bad_input():
    with pytest.raises(ValueError):
        native.rle_from_string("0P")        # the last code continues
    with pytest.raises(ValueError):
        native.rle_from_string("ab~")       # outside '0'..'o'
    with pytest.raises(ValueError):
        native.rle_encode(np.zeros((2, 2, 2), np.uint8))
    with pytest.raises(ValueError):
        trle.merge([])


@pytest.mark.parametrize("seed", range(4))
def test_evaluate_img_native_equals_plain(seed):
    """Ties (IoUs drawn from a few levels), ignored and crowd ground truth,
    D or G of 1, IoU exactly at the thresholds."""
    rng = np.random.RandomState(seed)
    for _ in range(8):
        D, G = rng.randint(1, 25), rng.randint(1, 12)
        ious = rng.choice([0.0, 0.5, 0.55, 0.75, 0.9, 1.0, rng.rand()],
                          (D, G)) if rng.rand() < 0.5 else rng.rand(D, G)
        gt_ig = np.sort(rng.rand(G) < 0.3)   # non-ignored first
        crowd = gt_ig & (rng.rand(G) < 0.5)
        m_n, ig_n = native.evaluate_img(ious, gt_ig, crowd, tmap.IOU_THRS)
        m_p, ig_p = tmap.match_plain(ious, gt_ig, crowd, tmap.IOU_THRS)
        np.testing.assert_array_equal(m_n, m_p)
        np.testing.assert_array_equal(ig_n, ig_p)
        assert m_n.dtype == np.int64 and ig_n.dtype == bool


def test_coco_map_native_and_plain_matchers_agree():
    from test_torch_port_eval_metrics import coco_case

    for iou_type in ("bbox", "segm"):
        gt, dets = coco_case(3, iou_type)
        a = tmap.COCOMeanAP(gt, iou_type).evaluate([dict(d) for d in dets])
        b = tmap.COCOMeanAP(gt, iou_type, match=tmap.match_plain).evaluate(
            [dict(d) for d in dets])
        assert a == b
        assert a == jmap.COCOMeanAP(gt, iou_type).evaluate(
            [dict(d) for d in dets])


@pytest.mark.parametrize("case", ["test_native_matches_python",
                                  "test_rle_merge_intersect",
                                  "test_coco_map_with_native_same_results"])
def test_jax_native_cases_on_the_port(case, monkeypatch):
    """tests/test_native.py's case with the port's matcher, codec and
    COCOMeanAP in place of JAX's."""
    import unicorn_tpu.evaluators as jev

    monkeypatch.setattr(jax_native_cases, "evaluate_img_native",
                        native.evaluate_img)
    monkeypatch.setattr(jax_native_cases, "COCOMeanAP", tmap.COCOMeanAP)
    monkeypatch.setattr(jev, "rle", trle)
    getattr(jax_native_cases, case)()


def test_failed_build_raises(monkeypatch):
    """A compiler that fails raises; nothing falls back to the plain
    forms."""
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="failed for rle.cpp"):
        build.build(["rle"])
