"""The port's copies of the host trackers (unicorn_torch.tracker: qd_tracker,
legacy, the Kalman filter's DeepSORT methods, the IoU conventions) against
the JAX package's, on the CPU.

Cases: seeded numpy detection sequences (moving boxes with jitter, missed
detections, low scores, clutter, classes, an appearance embedding per
object) through QuasiDenseEmbedTracker (every match metric, with and
without class gating), Sort, DeepSort and OnlineTracker (MOTDT) of both
packages; the JAX package's own tracker tests (tests/test_mots.py's
return_index cases, tests/test_legacy_trackers.py's SORT / DeepSORT / MOTDT
cases) run again with the port's classes in place of JAX's; the Kalman
filter's predict / project / update / gating_distance, CHI2INV95,
exclusive_iou_np and pairwise_iou_np against JAX's.

Tolerances: the two packages run the same numpy code on the same inputs,
so ids, labels, states and indices are equal and boxes, scores and Kalman
states within 1e-6 (numpy's own reproducibility, not a framework's).
"""
import numpy as np
import pytest

import test_legacy_trackers as legacy_cases
import test_mots as mots_cases
from unicorn_torch.tracker import kalman as tkalman
from unicorn_torch.tracker import legacy as tlegacy
from unicorn_torch.tracker import matching as tmatching
from unicorn_torch.tracker.qd_tracker import QuasiDenseEmbedTracker as TQD
from unicorn_torch.utils.boxes import pairwise_iou_np as t_pairwise_iou
from unicorn_tpu.tracker import kalman as jkalman
from unicorn_tpu.tracker import legacy as jlegacy
from unicorn_tpu.tracker import matching as jmatching
from unicorn_tpu.tracker.qd_tracker import QuasiDenseEmbedTracker as JQD
from unicorn_tpu.utils.boxes import pairwise_iou_np as j_pairwise_iou


def _stream(n_frames=30, n_obj=6, dim=16, seed=0):
    """Per frame: (boxes xyxy (N, 4), scores (N,), classes (N,), embeddings
    (N, dim)). Moving boxes with jitter, missed detections, mixed scores, a
    crossing pair, clutter; each object's embedding drifts around its own
    direction, clutter's is random."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(50, 400, (n_obj, 2))
    vel = rng.uniform(-5, 5, (n_obj, 2))
    vel[1] = (pos[0] - pos[1]) / 15.0      # object 1 crosses object 0
    size = rng.uniform(30, 80, (n_obj, 2))
    cls = rng.randint(0, 3, n_obj)
    app = rng.randn(n_obj, dim) * 3
    for t in range(n_frames):
        boxes, scores, classes, embeds = [], [], [], []
        for i in range(n_obj):
            if rng.rand() < 0.15:          # missed detection
                continue
            tl = pos[i] + t * vel[i] + rng.randn(2) * 1.5
            boxes.append(np.r_[tl, tl + size[i]])
            scores.append(rng.choice([0.95, 0.85, 0.6, 0.4, 0.2]))
            classes.append(cls[i])
            embeds.append(app[i] + rng.randn(dim) * 0.5)
        for _ in range(rng.randint(0, 3)):  # clutter
            tl = rng.uniform(0, 450, 2)
            boxes.append(np.r_[tl, tl + rng.uniform(20, 60, 2)])
            scores.append(rng.uniform(0.05, 0.9))
            classes.append(rng.randint(0, 3))
            embeds.append(rng.randn(dim) * 3)
        yield (np.asarray(boxes, np.float64).reshape(-1, 4),
               np.asarray(scores), np.asarray(classes, int),
               np.asarray(embeds, np.float32).reshape(-1, dim))


def _views(views):
    return [(v.track_id, v.cls, v.score, tuple(v.tlbr)) for v in views]


def _assert_views_equal(vt, vj):
    assert [v[:2] for v in vt] == [v[:2] for v in vj]
    for a, b in zip(vt, vj):
        np.testing.assert_allclose(a[2], b[2], atol=1e-6)
        np.testing.assert_allclose(a[3], b[3], atol=1e-6)


# ---------------------------------------------------------------- QDTrack
@pytest.mark.parametrize("kw", [
    dict(init_score_thr=0.7, obj_score_thr=0.5),
    dict(init_score_thr=0.7, obj_score_thr=0.5, match_metric="softmax"),
    dict(init_score_thr=0.7, obj_score_thr=0.5, match_metric="cosine",
         match_score_thr=0.8),
    dict(init_score_thr=0.5, obj_score_thr=0.3, with_cats=False,
         memo_tracklet_frames=5, memo_backdrop_frames=2),
])
def test_qd_tracker_copy_matches_jax_package(kw):
    tj, tt = JQD(**kw), TQD(**kw)
    n_ids, seen = 0, set()
    for frame, (boxes, scores, classes, embeds) in enumerate(_stream()):
        b5 = np.concatenate([boxes, scores[:, None]], 1)
        oj = tj.match(b5, classes, embeds, frame, return_index=True)
        ot = tt.match(b5, classes, embeds, frame, return_index=True)
        np.testing.assert_allclose(ot[0], oj[0], atol=1e-6)
        for a, b in zip(ot[1:], oj[1:]):
            np.testing.assert_array_equal(a, b)
        assert tt.num_tracklets == tj.num_tracklets
        assert sorted(tt.tracklets) == sorted(tj.tracklets)
        n_ids += int((ot[2] > -1).sum())
        seen.update(ot[2].tolist())
    # the stream exercises matches, new ids, unmatched and suppressed rows
    assert n_ids > 60 and {-1} <= seen and max(seen) > 5


# --------------------------------------------------------- SORT, DeepSORT
@pytest.mark.parametrize("kw", [dict(), dict(det_thresh=0.3, min_hits=1,
                                             max_age=3)])
def test_sort_copy_matches_jax_package(kw):
    tj, tt = jlegacy.Sort(**kw), tlegacy.Sort(**kw)
    n = 0
    for boxes, scores, _, _ in _stream(seed=1):
        oj, ot = tj.update(boxes, scores), tt.update(boxes, scores)
        np.testing.assert_allclose(ot, oj, atol=1e-6)
        np.testing.assert_array_equal(tt.track_id, tj.track_id)
        n += len(ot)
    assert n > 10


@pytest.mark.parametrize("kw", [dict(), dict(n_init=1, max_dist=0.4,
                                             max_age=5, nn_budget=3)])
def test_deepsort_copy_matches_jax_package(kw):
    tj, tt = jlegacy.DeepSort(**kw), tlegacy.DeepSort(**kw)
    n, coasting = 0, 0
    for boxes, scores, classes, embeds in _stream(seed=2):
        vj = _views(tj.update(boxes, scores, embeds, classes))
        vt = _views(tt.update(boxes, scores, embeds, classes))
        _assert_views_equal(vt, vj)
        assert tt.last_det_indices == tj.last_det_indices
        n += len(vt)
        coasting += tt.last_det_indices.count(-1)
    # an empty frame steps both tables alike
    vj = _views(tj.update(np.zeros((0, 4)), np.zeros((0,)),
                          np.zeros((0, 16))))
    vt = _views(tt.update(np.zeros((0, 4)), np.zeros((0,)),
                          np.zeros((0, 16))))
    _assert_views_equal(vt, vj)
    assert tt.last_det_indices == tj.last_det_indices
    np.testing.assert_array_equal(tt.time_since_update, tj.time_since_update)
    assert n > 40 and coasting > 0


@pytest.mark.parametrize("kw", [dict(), dict(use_tracking=False,
                                             use_refind=False,
                                             max_time_lost=4)])
def test_motdt_copy_matches_jax_package(kw):
    tj, tt = jlegacy.OnlineTracker(**kw), tlegacy.OnlineTracker(**kw)
    rng = np.random.RandomState(3)
    n = 0
    for boxes, scores, _, _ in _stream(seed=3):
        pj, pt = tj.propose(boxes, scores), tt.propose(boxes, scores)
        for a, b in zip(pt, pj):
            np.testing.assert_allclose(a, b, atol=1e-6)
        # the caller's appearance net: a smooth function of the box
        feats = np.concatenate([np.sin(pj[0] / 40.0), np.cos(pj[0] / 40.0)],
                               1) + rng.randn(len(pj[0]), 8) * 0.01
        vj = _views(tj.update(*pj, feats))
        vt = _views(tt.update(*pt, feats))
        _assert_views_equal(vt, vj)
        n += len(vt)
    assert n > 30


# -------------------------------------- the JAX package's own tracker tests
LEGACY_CASES = [
    "test_sort_identity_and_min_hits", "test_sort_max_age_expiry_new_id",
    "test_sort_det_thresh_and_predicted_motion",
    "test_deepsort_n_init_confirmation",
    "test_deepsort_appearance_keeps_identity_through_crossing",
    "test_deepsort_reid_after_occlusion",
    "test_deepsort_tentative_drop_same_frame_as_match",
    "test_deepsort_gallery_budget",
    "test_motdt_candidate_bridges_missed_detection",
    "test_motdt_no_tracking_candidates_no_bridge",
    "test_motdt_new_tracks_only_from_detections",
    "test_motdt_activation_delay_and_lost_refind",
    "test_deepsort_carries_class_labels",
]


@pytest.mark.parametrize("case", LEGACY_CASES)
def test_legacy_tracker_cases_on_the_port(case, monkeypatch):
    """tests/test_legacy_trackers.py's case, its Sort / DeepSort /
    OnlineTracker replaced by the port's."""
    for name in ("Sort", "DeepSort", "OnlineTracker"):
        monkeypatch.setattr(legacy_cases, name, getattr(tlegacy, name))
    getattr(legacy_cases, case)()


@pytest.mark.parametrize("case", [
    "test_qd_tracker_return_index_realigns_any_input_order",
    "test_qd_tracker_return_index_consistent_across_frames"])
def test_qd_return_index_cases_on_the_port(case, monkeypatch):
    """tests/test_mots.py's return_index case with the port's
    QuasiDenseEmbedTracker."""
    monkeypatch.setattr(mots_cases, "QuasiDenseEmbedTracker", TQD)
    getattr(mots_cases, case)()


# ------------------------------------------------- Kalman filter, IoU forms
def _kalman_states(rng, n=5):
    kf = jkalman.KalmanFilter()
    states = []
    for _ in range(n):
        meas = np.r_[rng.uniform(50, 500, 2), rng.uniform(0.3, 2.0),
                     rng.uniform(20, 200)]
        mean, cov = kf.initiate(meas)
        for _ in range(rng.randint(1, 4)):
            mean, cov = kf.predict(mean, cov)
        states.append((mean, cov))
    return states


def test_kalman_filter_methods_match_jax_package():
    assert tkalman.CHI2INV95 == jkalman.CHI2INV95
    rng = np.random.RandomState(4)
    kj, kt = jkalman.KalmanFilter(), tkalman.KalmanFilter()
    for mean, cov in _kalman_states(rng):
        for a, b in zip(kt.predict(mean, cov), kj.predict(mean, cov)):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-6)
        for a, b in zip(kt.project(mean, cov), kj.project(mean, cov)):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-6)
        meas = mean[:4] + rng.randn(4) * np.r_[5, 5, 0.05, 5]
        for a, b in zip(kt.update(mean, cov, meas),
                        kj.update(mean, cov, meas)):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-6)
        cands = mean[:4] + rng.randn(7, 4) * np.r_[20, 20, 0.2, 20]
        for kw in (dict(), dict(only_position=True),
                   dict(metric="gaussian")):
            np.testing.assert_allclose(
                kt.gating_distance(mean, cov, cands, **kw),
                kj.gating_distance(mean, cov, cands, **kw), rtol=1e-12,
                atol=1e-6)


def test_kalman_update_agrees_with_the_batched_form():
    """The DeepSORT update (Cholesky) and ByteTrack's multi_update (batched
    solve) are one filter."""
    rng = np.random.RandomState(5)
    kf = tkalman.KalmanFilter()
    states = _kalman_states(rng)
    means = np.stack([m for m, _ in states])
    covs = np.stack([c for _, c in states])
    meas = means[:, :4] + rng.randn(len(means), 4)
    bm, bc = kf.multi_update(means, covs, meas)
    for i, (m, c) in enumerate(states):
        um, uc = kf.update(m, c, meas[i])
        np.testing.assert_allclose(um, bm[i], rtol=1e-9, atol=1e-6)
        np.testing.assert_allclose(uc, bc[i], rtol=1e-9, atol=1e-6)


def test_iou_conventions_match_jax_package():
    rng = np.random.RandomState(6)
    tl = rng.uniform(0, 100, (9, 2))
    a = np.concatenate([tl, tl + rng.uniform(2, 40, (9, 2))], 1)
    tl = rng.uniform(0, 100, (6, 2))
    b = np.concatenate([tl, tl + rng.uniform(2, 40, (6, 2))], 1)
    for t_fn, j_fn in ((tmatching.exclusive_iou_np, jmatching.exclusive_iou_np),
                       (tmatching.inclusive_iou_np, jmatching.inclusive_iou_np),
                       (t_pairwise_iou, j_pairwise_iou)):
        np.testing.assert_array_equal(t_fn(a, b), j_fn(a, b))
        assert t_fn(a[:0], b).shape == (0, 6)
    # the two conventions differ: +1 inflates small boxes' IoU
    small = np.array([[0.0, 0.0, 10.0, 10.0]])
    shifted = small + 5.0
    assert tmatching.exclusive_iou_np(small, shifted)[0, 0] == \
        pytest.approx(25 / 175)
    assert tmatching.inclusive_iou_np(small, shifted)[0, 0] == \
        pytest.approx(36 / 206)
