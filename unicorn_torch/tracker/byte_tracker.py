"""Host-side BYTE association over a struct-of-arrays track table, numpy.

A copy of unicorn_tpu/tracker/byte_tracker.py (the port imports nothing of
the JAX package). The tracker state is a dense table of per-track rows (Kalman mean/cov, lifecycle
state, id, score, frame stamps) and every step is a vectorized numpy pass —
batched Kalman predict/update, one cost matrix per association stage, scipy
Hungarian with lapjv cost-limit semantics (matching.linear_assignment).

The *algorithm* is BYTE (Zhang et al. 2021, MIT-licensed; vendored by the
reference at unicorn/tracker/byte_tracker.py:147-296, which is the behavior
anchor for MOT17 parity): split detections at track_thresh, associate
high-score detections to the tracked+lost pool by Kalman-predicted IoU fused
with detection score, rescue remaining tracked rows with low-score
detections, give unconfirmed (single-frame) tracks one chance at the leftover
high-score detections, start new tracks from strong leftovers, expire lost
rows after a buffer, and de-duplicate tracked-vs-lost overlaps.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from . import matching
from .kalman import KalmanFilter

# lifecycle states of a table row
TRACKED, LOST = 1, 2


class TrackView(NamedTuple):
    """Per-frame snapshot of one track, returned by ByteTracker.update."""
    track_id: int
    score: float
    tlwh: np.ndarray   # (4,) top-left x, y, w, h
    tlbr: np.ndarray   # (4,) x1, y1, x2, y2
    cls: int = 0       # detection class (multi-class trackers; 0 otherwise)


def _xyxy_to_xyah(boxes: np.ndarray) -> np.ndarray:
    """(N,4) xyxy -> (N,4) [cx, cy, aspect, h] measurement space."""
    boxes = np.asarray(boxes, np.float64).reshape(-1, 4)
    w = boxes[:, 2] - boxes[:, 0]
    h = boxes[:, 3] - boxes[:, 1]
    return np.stack([
        (boxes[:, 0] + boxes[:, 2]) / 2,
        (boxes[:, 1] + boxes[:, 3]) / 2,
        w / np.maximum(h, 1e-12),
        h,
    ], axis=1)


def _mean_to_tlbr(means: np.ndarray) -> np.ndarray:
    """(N,8) Kalman means (cxcyah…) -> (N,4) xyxy."""
    cx, cy, a, h = means[:, 0], means[:, 1], means[:, 2], means[:, 3]
    w = a * h
    return np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], axis=1)


class ByteTracker:
    """BYTE association over a row table; one `update` call per frame.

    update(boxes_xyxy (N,4), scores (N,)) -> list[TrackView] of the currently
    activated tracked rows. Track ids are per-instance, starting at 1, and
    issued in ascending detection order (reference id semantics).
    """

    def __init__(self, track_thresh=0.6, track_buffer=30, match_thresh=0.9,
                 frame_rate=30, mot20=False):
        self.track_thresh = float(track_thresh)
        self.match_thresh = float(match_thresh)
        self.det_thresh = self.track_thresh + 0.1
        self.max_time_lost = int(frame_rate / 30.0 * track_buffer)
        self.mot20 = mot20
        self.kalman_filter = KalmanFilter()

        self.frame_id = 0
        self._next_id = 1
        # the table: one row per live track (tracked, unconfirmed, or lost)
        self.mean = np.zeros((0, 8))
        self.cov = np.zeros((0, 8, 8))
        self.state = np.zeros((0,), np.int32)
        self.activated = np.zeros((0,), bool)
        self.score = np.zeros((0,))
        self.track_id = np.zeros((0,), np.int64)
        self.cls = np.zeros((0,), np.int64)
        self.last_frame = np.zeros((0,), np.int64)   # frame of last update
        self.start_frame = np.zeros((0,), np.int64)

    # -- table helpers -------------------------------------------------------

    def _keep(self, mask: np.ndarray) -> None:
        """Drop rows where mask is False."""
        for name in ("mean", "cov", "state", "activated", "score",
                     "track_id", "cls", "last_frame", "start_frame"):
            setattr(self, name, getattr(self, name)[mask])

    def _append_new(self, boxes: np.ndarray, scores: np.ndarray,
                    classes=None) -> None:
        """Initiate one new row per detection (in det order -> ascending ids)."""
        n = len(boxes)
        if n == 0:
            return
        meas = _xyxy_to_xyah(boxes)
        means = np.zeros((n, 8))
        covs = np.zeros((n, 8, 8))
        for i in range(n):
            means[i], covs[i] = self.kalman_filter.initiate(meas[i])
        self.mean = np.concatenate([self.mean, means])
        self.cov = np.concatenate([self.cov, covs])
        self.state = np.concatenate(
            [self.state, np.full(n, TRACKED, np.int32)])
        # only first-frame tracks are born activated
        self.activated = np.concatenate(
            [self.activated, np.full(n, self.frame_id == 1, bool)])
        self.score = np.concatenate([self.score, scores.astype(np.float64)])
        ids = np.arange(self._next_id, self._next_id + n, dtype=np.int64)
        self._next_id += n
        self.track_id = np.concatenate([self.track_id, ids])
        self.cls = np.concatenate(
            [self.cls, np.zeros(n, np.int64) if classes is None
             else np.asarray(classes, np.int64)])
        self.last_frame = np.concatenate(
            [self.last_frame, np.full(n, self.frame_id, np.int64)])
        self.start_frame = np.concatenate(
            [self.start_frame, np.full(n, self.frame_id, np.int64)])

    def _record(self, stage: int, rows: np.ndarray, matches: np.ndarray,
                det_global: np.ndarray) -> None:
        for r, d in matches:
            self.last_matches[int(self.track_id[rows[r]])] = \
                (stage, int(det_global[d]))

    def _match_rows(self, rows: np.ndarray, det_boxes: np.ndarray,
                    det_scores: np.ndarray, thresh: float, fuse: bool):
        """One association stage: Hungarian on 1 - IoU (optionally score-fused)
        between table rows `rows` and the given detections."""
        cost = 1.0 - matching.inclusive_iou_np(
            _mean_to_tlbr(self.mean[rows]).astype(np.float32),
            np.asarray(det_boxes, np.float32))
        if fuse and not self.mot20:
            cost = 1.0 - (1.0 - cost) * det_scores[None, :]
        return matching.linear_assignment(cost, thresh)

    def _apply_matches(self, rows: np.ndarray, matches: np.ndarray,
                       det_boxes: np.ndarray, det_scores: np.ndarray,
                       det_classes=None) -> None:
        """Batched Kalman update + lifecycle transition for matched rows."""
        if len(matches) == 0:
            return
        r = rows[matches[:, 0]]
        d = matches[:, 1]
        meas = _xyxy_to_xyah(det_boxes[d])
        self.mean[r], self.cov[r] = self.kalman_filter.multi_update(
            self.mean[r], self.cov[r], meas)
        self.state[r] = TRACKED
        self.activated[r] = True
        self.score[r] = det_scores[d]
        if det_classes is not None:
            self.cls[r] = np.asarray(det_classes, np.int64)[d]
        self.last_frame[r] = self.frame_id

    # -- the per-frame step --------------------------------------------------

    def update(self, boxes_xyxy, scores, classes=None):
        self.frame_id += 1
        boxes = np.asarray(boxes_xyxy, np.float64).reshape(-1, 4)
        scores = np.asarray(scores, np.float64).reshape(-1)
        # per-frame debug trace for parity tests: {track_id: (stage, det_idx)}
        self.last_matches = {}

        cls = (np.zeros(len(scores), np.int64) if classes is None
               else np.asarray(classes, np.int64).reshape(-1))
        high = scores > self.track_thresh
        low = (scores > 0.1) & (scores < self.track_thresh)
        dets_high, s_high, c_high = boxes[high], scores[high], cls[high]
        dets_low, s_low, c_low = boxes[low], scores[low], cls[low]

        is_unconf = (self.state == TRACKED) & ~self.activated
        pool = ((self.state == TRACKED) & self.activated) | (self.state == LOST)
        pool_rows = np.flatnonzero(pool)

        # Kalman predict on the pool (lost rows zero their h-velocity);
        # unconfirmed rows keep their initiate-time state (reference predicts
        # only the tracked+lost pool).
        if len(pool_rows):
            m = self.mean[pool_rows].copy()
            m[self.state[pool_rows] == LOST, 7] = 0.0
            self.mean[pool_rows], self.cov[pool_rows] = \
                self.kalman_filter.multi_predict(m, self.cov[pool_rows])

        # stage 1: pool vs high-score dets, score-fused IoU
        matches, u_track, u_det = self._match_rows(
            pool_rows, dets_high, s_high, self.match_thresh, fuse=True)
        self._record(1, pool_rows, matches, np.flatnonzero(high))
        self._apply_matches(pool_rows, matches, dets_high, s_high, c_high)

        # stage 2: remaining *tracked* pool rows vs low-score dets, plain IoU
        r_rows = pool_rows[list(u_track)]
        r_rows = r_rows[self.state[r_rows] == TRACKED]
        matches2, u_track2, _ = self._match_rows(
            r_rows, dets_low, s_low, 0.5, fuse=False)
        self._record(2, r_rows, matches2, np.flatnonzero(low))
        self._apply_matches(r_rows, matches2, dets_low, s_low, c_low)
        self.state[r_rows[list(u_track2)]] = LOST  # unmatched tracked -> lost

        # stage 3: unconfirmed rows vs leftover high-score dets
        u_det = np.asarray(u_det, int)
        unconf_rows = np.flatnonzero(is_unconf)
        matches3, u_unconf, u_det3 = self._match_rows(
            unconf_rows, dets_high[u_det], s_high[u_det],
            0.7, fuse=True)
        self._record(3, unconf_rows, matches3, np.flatnonzero(high)[u_det])
        self._apply_matches(unconf_rows, matches3, dets_high[u_det],
                            s_high[u_det], c_high[u_det])

        # unmatched unconfirmed rows are removed outright
        remove = np.zeros(len(self.state), bool)
        remove[unconf_rows[list(u_unconf)]] = True
        # lost rows past the buffer expire
        remove |= (self.state == LOST) & \
            (self.frame_id - self.last_frame > self.max_time_lost)
        self._keep(~remove)

        # new tracks from strong leftover detections (ascending det order)
        leftover = u_det[list(u_det3)]
        strong = leftover[s_high[leftover] >= self.det_thresh]
        strong = np.sort(strong)
        self._append_new(dets_high[strong], s_high[strong],
                         c_high[strong])

        # de-duplicate tracked vs lost (IoU > 0.85), keeping the longer-lived
        self._remove_duplicates()

        out_rows = np.flatnonzero((self.state == TRACKED) & self.activated)
        tlbr = _mean_to_tlbr(self.mean[out_rows])
        views = []
        for k, r in enumerate(out_rows):
            b = tlbr[k]
            views.append(TrackView(
                track_id=int(self.track_id[r]), score=float(self.score[r]),
                tlwh=np.array([b[0], b[1], b[2] - b[0], b[3] - b[1]]),
                tlbr=b.copy(), cls=int(self.cls[r])))
        return views

    def _remove_duplicates(self) -> None:
        """Drop whichever of an overlapping (tracked, lost) pair is younger."""
        t_rows = np.flatnonzero(self.state == TRACKED)
        l_rows = np.flatnonzero(self.state == LOST)
        if len(t_rows) == 0 or len(l_rows) == 0:
            return
        dist = 1.0 - matching.inclusive_iou_np(
            _mean_to_tlbr(self.mean[t_rows]).astype(np.float32),
            _mean_to_tlbr(self.mean[l_rows]).astype(np.float32))
        p, q = np.where(dist < 0.15)
        age_t = self.last_frame[t_rows[p]] - self.start_frame[t_rows[p]]
        age_l = self.last_frame[l_rows[q]] - self.start_frame[l_rows[q]]
        remove = np.zeros(len(self.state), bool)
        remove[t_rows[p[age_t <= age_l]]] = True
        remove[l_rows[q[age_t > age_l]]] = True
        self._keep(~remove)
