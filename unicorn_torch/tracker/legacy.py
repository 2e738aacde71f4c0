"""Legacy association baselines: SORT, DeepSORT, MOTDT (the port's copy
of unicorn_tpu/tracker/legacy.py).

The reference keeps evaluator branches for these three trackers
(unicorn/evaluators/mot_evaluator.py:247-615 — evaluate_sort /
evaluate_deepsort / evaluate_motdt) but the tracker modules themselves
(`unicorn.sort_tracker`, `unicorn.deepsort_tracker`, `unicorn.motdt_tracker`)
are absent from the reference tree and their imports are commented out
(mot_evaluator.py:17-19), so those branches cannot run there. They are
re-built here from the published algorithms (SORT: Bewley et al. 2016,
arXiv:1602.00763; DeepSORT: Wojke et al. 2017, arXiv:1703.07402; MOTDT:
Chen et al. 2018, arXiv:1809.04427) in the same vectorized
struct-of-arrays style as tracker/byte_tracker.py — a dense row table per
tracker, batched Kalman passes, one cost matrix per association stage.

One deliberate substitution, documented in PARITY.md: DeepSORT and MOTDT
associate with an appearance embedding per candidate box. The reference
design loads a *separate* torch ReID CNN (the `model_folder` argument its
dead evaluator branches pass) and re-crops the original image per box on the
host; that ReID checkpoint is not shipped anywhere in the reference. Here
the embeddings come from the unified model's own quasi-dense embedding head
(the same features the QDTrack path uses), passed in by the caller — no
second network, no host re-crops, and the whole embedding batch is one
device call (drivers/mot.py MOTOmniDriver(tracker="deepsort"); in the JAX
package also MOTEvaluator.evaluate_omni(tracker="deepsort"|"motdt")).
"""
from __future__ import annotations

import numpy as np

from . import matching
from .byte_tracker import TrackView, _xyxy_to_xyah, _mean_to_tlbr
from .kalman import CHI2INV95, KalmanFilter

__all__ = ["Sort", "DeepSort", "OnlineTracker"]


# ---------------------------------------------------------------------------
# SORT (Bewley et al. 2016)
# ---------------------------------------------------------------------------

def _xyxy_to_csr(boxes: np.ndarray) -> np.ndarray:
    """(N,4) xyxy -> (N,4) [cx, cy, scale=area, aspect=w/h] (SORT state)."""
    boxes = np.asarray(boxes, np.float64).reshape(-1, 4)
    w = boxes[:, 2] - boxes[:, 0]
    h = boxes[:, 3] - boxes[:, 1]
    return np.stack([
        (boxes[:, 0] + boxes[:, 2]) / 2,
        (boxes[:, 1] + boxes[:, 3]) / 2,
        w * h,
        w / np.maximum(h, 1e-12),
    ], axis=1)


def _csr_to_tlbr(means: np.ndarray) -> np.ndarray:
    """(N,>=4) [cx, cy, s, r, ...] -> (N,4) xyxy. A non-positive area
    yields NaN (the original's drop-tracker-on-NaN-prediction signal)."""
    with np.errstate(invalid="ignore"):
        w = np.sqrt(means[:, 2] * means[:, 3])
    h = means[:, 2] / np.maximum(w, 1e-12)
    cx, cy = means[:, 0], means[:, 1]
    return np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], axis=1)


class _SortKalman:
    """Batched 7-state constant-velocity filter of the original SORT.

    State [cx, cy, s, r, vcx, vcy, vs]: area has a velocity, aspect ratio is
    held constant. Noise/initial-covariance constants are the published ones
    (Bewley's sort.py KalmanBoxTracker): P0 = diag([10,10,10,10,1e4,1e4,1e4]),
    Q = diag([1,1,1,1,.01,.01,1e-4]), R = diag([1,1,10,10]).
    """

    def __init__(self):
        self.F = np.eye(7)
        self.F[0, 4] = self.F[1, 5] = self.F[2, 6] = 1.0
        self.P0 = np.diag([10.0, 10.0, 10.0, 10.0, 1e4, 1e4, 1e4])
        self.Q = np.diag([1.0, 1.0, 1.0, 1.0, 0.01, 0.01, 1e-4])
        self.R = np.diag([1.0, 1.0, 10.0, 10.0])

    def initiate(self, meas: np.ndarray):
        n = len(meas)
        means = np.zeros((n, 7))
        means[:, :4] = meas
        covs = np.tile(self.P0, (n, 1, 1))
        return means, covs

    def predict(self, means: np.ndarray, covs: np.ndarray):
        if len(means) == 0:
            return means, covs
        # area-velocity guard of the original: a predicted non-positive area
        # zeroes the area velocity instead of going negative
        vs_bad = means[:, 6] + means[:, 2] <= 0
        means = means.copy()
        means[vs_bad, 6] = 0.0
        means = means @ self.F.T
        covs = self.F @ covs @ self.F.T + self.Q
        return means, covs

    def update(self, means: np.ndarray, covs: np.ndarray, meas: np.ndarray):
        if len(means) == 0:
            return means, covs
        S = covs[:, :4, :4] + self.R                       # (N,4,4)
        CHt = covs[:, :, :4]                               # (N,7,4)
        K = np.linalg.solve(S, CHt.transpose(0, 2, 1)).transpose(0, 2, 1)
        innovation = meas - means[:, :4]
        new_means = means + (K @ innovation[..., None])[..., 0]
        new_covs = covs - K @ S @ K.transpose(0, 2, 1)
        return new_means, new_covs


class Sort:
    """SORT over a row table; `update(boxes_xyxy, scores)` per frame.

    Returns an (K, 5) array of [x1, y1, x2, y2, track_id] for rows updated
    this frame whose hit streak has reached min_hits (always emitted during
    the first min_hits frames) — the original output rule. Defaults are the
    ones the reference's dead evaluate_sort branch would have passed to the
    ByteTrack-repo Sort (det_thresh from --track_thresh; max_age 30,
    min_hits 3, iou 0.3).
    """

    def __init__(self, det_thresh=0.6, max_age=30, min_hits=3,
                 iou_threshold=0.3):
        self.det_thresh = float(det_thresh)
        self.max_age = int(max_age)
        self.min_hits = int(min_hits)
        self.iou_threshold = float(iou_threshold)
        self.kf = _SortKalman()
        self.frame_count = 0
        self._next_id = 1
        self.mean = np.zeros((0, 7))
        self.cov = np.zeros((0, 7, 7))
        self.track_id = np.zeros((0,), np.int64)
        self.hit_streak = np.zeros((0,), np.int64)
        self.time_since_update = np.zeros((0,), np.int64)

    def _keep(self, mask: np.ndarray) -> None:
        for name in ("mean", "cov", "track_id", "hit_streak",
                     "time_since_update"):
            setattr(self, name, getattr(self, name)[mask])

    def update(self, boxes_xyxy, scores) -> np.ndarray:
        self.frame_count += 1
        boxes = np.asarray(boxes_xyxy, np.float64).reshape(-1, 4)
        scores = np.asarray(scores, np.float64).reshape(-1)
        keep = scores > self.det_thresh
        dets = boxes[keep]

        # predict every row; a row whose streak broke last frame resets it
        self.hit_streak[self.time_since_update > 0] = 0
        self.time_since_update += 1
        self.mean, self.cov = self.kf.predict(self.mean, self.cov)
        # the original drops trackers whose predicted box goes non-finite
        finite = np.isfinite(_csr_to_tlbr(self.mean)).all(axis=1) \
            if len(self.mean) else np.zeros((0,), bool)
        self._keep(finite)

        # IoU Hungarian with the published SORT semantics: exclusive IoU
        # (sort.py iou_batch has no +1) and pairs AT the threshold kept —
        # the original rejects only iou < iou_threshold, while
        # linear_assignment keeps cost < limit (strict), so nudge the limit
        # by an epsilon to re-admit exact-threshold pairs
        iou = matching.exclusive_iou_np(
            _csr_to_tlbr(self.mean).astype(np.float32),
            dets.astype(np.float32))
        matches, _, u_det = matching.linear_assignment(
            -iou.astype(np.float64), -(self.iou_threshold - 1e-9))

        if len(matches):
            r, d = matches[:, 0], matches[:, 1]
            self.mean[r], self.cov[r] = self.kf.update(
                self.mean[r], self.cov[r], _xyxy_to_csr(dets[d]))
            self.hit_streak[r] += 1
            self.time_since_update[r] = 0

        # new rows from unmatched detections
        new = dets[list(u_det)]
        if len(new):
            m, c = self.kf.initiate(_xyxy_to_csr(new))
            self.mean = np.concatenate([self.mean, m])
            self.cov = np.concatenate([self.cov, c])
            ids = np.arange(self._next_id, self._next_id + len(new),
                            dtype=np.int64)
            self._next_id += len(new)
            self.track_id = np.concatenate([self.track_id, ids])
            self.hit_streak = np.concatenate(
                [self.hit_streak, np.zeros(len(new), np.int64)])
            self.time_since_update = np.concatenate(
                [self.time_since_update, np.zeros(len(new), np.int64)])

        out = (self.time_since_update < 1) & (
            (self.hit_streak >= self.min_hits)
            | (self.frame_count <= self.min_hits))
        tlbr = _csr_to_tlbr(self.mean[out])
        result = np.concatenate(
            [tlbr, self.track_id[out, None].astype(np.float64)], axis=1)

        self._keep(self.time_since_update <= self.max_age)
        return result


# ---------------------------------------------------------------------------
# shared appearance-table helpers (DeepSORT / MOTDT)
# ---------------------------------------------------------------------------

def _normalize(feats: np.ndarray) -> np.ndarray:
    feats = np.asarray(feats, np.float32).reshape(len(feats), -1)
    return feats / (np.linalg.norm(feats, axis=1, keepdims=True) + 1e-12)


class _AppearanceTable:
    """Mixin state shared by the two appearance trackers: an 8-dim cxcyah
    Kalman row table (the DeepSORT-lineage filter in tracker/kalman.py) plus
    per-row appearance storage managed by the subclass."""

    _COLS = ("mean", "cov", "track_id", "state", "hits", "time_since_update",
             "score", "cls")

    def _init_table(self):
        self.kf = KalmanFilter()
        self._next_id = 1
        self.mean = np.zeros((0, 8))
        self.cov = np.zeros((0, 8, 8))
        self.track_id = np.zeros((0,), np.int64)
        self.state = np.zeros((0,), np.int32)
        self.hits = np.zeros((0,), np.int64)
        self.time_since_update = np.zeros((0,), np.int64)
        self.score = np.zeros((0,))
        self.cls = np.zeros((0,), np.int64)

    def _keep_rows(self, mask: np.ndarray) -> None:
        for name in self._COLS:
            setattr(self, name, getattr(self, name)[mask])

    def _append_rows(self, boxes, scores, state, classes=None) -> np.ndarray:
        n = len(boxes)
        idx = np.arange(len(self.mean), len(self.mean) + n)
        if n == 0:
            return idx
        meas = _xyxy_to_xyah(boxes)
        means = np.zeros((n, 8))
        covs = np.zeros((n, 8, 8))
        for i in range(n):
            means[i], covs[i] = self.kf.initiate(meas[i])
        self.mean = np.concatenate([self.mean, means])
        self.cov = np.concatenate([self.cov, covs])
        ids = np.arange(self._next_id, self._next_id + n, dtype=np.int64)
        self._next_id += n
        self.track_id = np.concatenate([self.track_id, ids])
        self.state = np.concatenate(
            [self.state, np.full(n, state, np.int32)])
        self.hits = np.concatenate([self.hits, np.ones(n, np.int64)])
        self.time_since_update = np.concatenate(
            [self.time_since_update, np.zeros(n, np.int64)])
        self.score = np.concatenate(
            [self.score, np.asarray(scores, np.float64)])
        self.cls = np.concatenate(
            [self.cls, np.zeros(n, np.int64) if classes is None
             else np.asarray(classes, np.int64)])
        return idx

    def _kalman_update_rows(self, rows, boxes, scores, classes=None) -> None:
        if len(rows) == 0:
            return
        meas = _xyxy_to_xyah(boxes)
        self.mean[rows], self.cov[rows] = self.kf.multi_update(
            self.mean[rows], self.cov[rows], meas)
        self.hits[rows] += 1
        self.time_since_update[rows] = 0
        self.score[rows] = scores
        if classes is not None:
            self.cls[rows] = np.asarray(classes, np.int64)

    def _gate_cost(self, cost, rows, boxes, gated_value=1e5) -> np.ndarray:
        """Set cost to gated_value where the Mahalanobis distance of the
        box measurement from the row's predicted state exceeds the 4-dof
        chi-square 0.95 gate (the DeepSORT/MOTDT motion gate)."""
        if cost.size == 0:
            return cost
        meas = _xyxy_to_xyah(boxes)
        for i, r in enumerate(rows):
            gd = self.kf.gating_distance(self.mean[r], self.cov[r], meas)
            cost[i, gd > CHI2INV95[4]] = gated_value
        return cost

    def _views(self, rows) -> list:
        tlbr = _mean_to_tlbr(self.mean[rows])
        return [TrackView(track_id=int(self.track_id[r]),
                          score=float(self.score[r]),
                          tlwh=np.array([b[0], b[1], b[2] - b[0],
                                         b[3] - b[1]]),
                          tlbr=b.copy(), cls=int(self.cls[r]))
                for r, b in zip(rows, tlbr)]


# ---------------------------------------------------------------------------
# DeepSORT (Wojke et al. 2017)
# ---------------------------------------------------------------------------

# DeepSORT track lifecycle
TENTATIVE, CONFIRMED = 1, 2


class DeepSort(_AppearanceTable):
    """DeepSORT: appearance matching cascade + IoU fallback.

    update(boxes_xyxy, scores, feats) -> list[TrackView] of confirmed rows
    seen within the last frame (the original's time_since_update <= 1 output
    rule). feats is one embedding row per detection — here the unified
    model's quasi-dense embedding head output (see module docstring).

    Constants are the published DeepSORT/ByteTrack-vendored defaults:
    cosine gallery radius max_dist=0.2 with an nn_budget=100 gallery,
    Mahalanobis 4-dof chi-square gating, IoU stage at max_iou_distance=0.7
    for unconfirmed + just-missed rows, n_init=3 to confirm, max_age=70.
    """

    def __init__(self, max_dist=0.2, min_confidence=0.3,
                 max_iou_distance=0.7, max_age=70, n_init=3, nn_budget=100):
        self.max_dist = float(max_dist)
        self.min_confidence = float(min_confidence)
        self.max_iou_distance = float(max_iou_distance)
        self.max_age = int(max_age)
        self.n_init = int(n_init)
        self.nn_budget = int(nn_budget)
        self._init_table()
        self.gallery: list[list[np.ndarray]] = []  # per-row feature deque
        # caller-detection index behind each view returned by the LAST
        # update() call (-1 = track output without a detection this frame);
        # the per-detection-payload (MOTS mask) alignment contract, the
        # DeepSORT analogue of QuasiDenseEmbedTracker.match(return_index)
        self.last_det_indices: list[int] = []

    def _keep_rows(self, mask: np.ndarray) -> None:
        super()._keep_rows(mask)
        self.gallery = [g for g, k in zip(self.gallery, mask) if k]

    def _nn_cosine_cost(self, rows, det_feats) -> np.ndarray:
        """cost[i,j] = min over row i's gallery of cosine distance to det j
        (the NearestNeighborDistanceMetric with cosine)."""
        cost = np.zeros((len(rows), len(det_feats)), np.float64)
        if cost.size == 0:
            return cost
        for i, r in enumerate(rows):
            # gallery entries are unit-norm by construction (appended from
            # the update()-normalized feats), so no re-normalization here
            g = np.stack(self.gallery[r])
            cost[i] = 1.0 - (g @ det_feats.T).max(axis=0)
        return cost

    def update(self, boxes_xyxy, scores, feats, classes=None) -> list:
        boxes = np.asarray(boxes_xyxy, np.float64).reshape(-1, 4)
        scores = np.asarray(scores, np.float64).reshape(-1)
        classes = np.zeros(len(boxes), np.int64) if classes is None \
            else np.asarray(classes, np.int64).reshape(-1)
        feats = _normalize(np.asarray(feats).reshape(len(boxes), -1)) \
            if len(boxes) else np.zeros((0, 1), np.float32)
        keep = scores >= self.min_confidence
        orig_idx = np.flatnonzero(keep)  # post-keep det -> caller det index
        boxes, scores, feats, classes = \
            boxes[keep], scores[keep], feats[keep], classes[keep]

        # predict all rows
        self.time_since_update += 1
        self.mean, self.cov = self.kf.multi_predict(self.mean, self.cov)

        # 1) matching cascade: confirmed rows by ascending miss age, each
        # level an appearance-NN Hungarian gated by Mahalanobis distance
        matched_rows: list[int] = []
        matched_dets: list[int] = []
        u_det = np.arange(len(boxes))
        for level in range(self.max_age):
            if len(u_det) == 0:
                break
            rows = np.flatnonzero((self.state == CONFIRMED)
                                  & (self.time_since_update == 1 + level))
            if len(rows) == 0:
                continue
            cost = self._nn_cosine_cost(rows, feats[u_det])
            cost[cost > self.max_dist] = self.max_dist + 1e-5
            cost = self._gate_cost(cost, rows, boxes[u_det])
            m, _, um = matching.linear_assignment(cost, self.max_dist)
            matched_rows += [int(rows[a]) for a, _ in m]
            matched_dets += [int(u_det[b]) for _, b in m]
            u_det = u_det[list(um)]

        # 2) IoU stage: tentative rows + confirmed rows missed exactly this
        # frame, against the leftover detections
        iou_rows = np.flatnonzero(
            (self.state == TENTATIVE)
            | ((self.state == CONFIRMED) & (self.time_since_update == 1)))
        iou_rows = np.array([r for r in iou_rows if r not in matched_rows],
                            int)
        # published DeepSORT iou_matching.iou is exclusive (no +1)
        cost = 1.0 - matching.exclusive_iou_np(
            _mean_to_tlbr(self.mean[iou_rows]).astype(np.float32),
            boxes[u_det].astype(np.float32))
        m, _, um = matching.linear_assignment(
            cost.astype(np.float64), self.max_iou_distance)
        matched_rows += [int(iou_rows[a]) for a, _ in m]
        matched_dets += [int(u_det[b]) for _, b in m]
        u_det = u_det[list(um)]

        # 3) apply matches: Kalman update, gallery append, confirm at n_init
        rows = np.asarray(matched_rows, int)
        dets = np.asarray(matched_dets, int)
        self._kalman_update_rows(rows, boxes[dets], scores[dets],
                                 classes[dets])
        for r, d in zip(rows, dets):
            self.gallery[r].append(feats[d])
            if len(self.gallery[r]) > self.nn_budget:
                self.gallery[r] = self.gallery[r][-self.nn_budget:]
        confirm = np.zeros(len(self.state), bool)
        confirm[rows] = True
        self.state[confirm & (self.state == TENTATIVE)
                    & (self.hits >= self.n_init)] = CONFIRMED
        # snapshot matched track ids NOW: steps 4-5 compact/append rows, so
        # the row indices in `rows` go stale (track ids never do)
        matched_tids = [int(t) for t in self.track_id[rows]]

        # 4) deletions: missed tentative rows, over-age confirmed rows
        missed = np.ones(len(self.state), bool)
        missed[rows] = False
        drop = (missed & (self.state == TENTATIVE)) \
            | (self.time_since_update > self.max_age)
        self._keep_rows(~drop)

        # 5) new tentative rows from leftover detections
        new_idx = self._append_rows(boxes[u_det], scores[u_det], TENTATIVE,
                                    classes[u_det])
        for d in u_det:
            self.gallery.append([feats[d]])
        if self.n_init <= 1:
            self.state[new_idx] = CONFIRMED

        # row indices shift across deletions/appends; key the per-frame
        # detection provenance by track id (snapshotted pre-compaction)
        det_of_tid = {tid: int(orig_idx[d])
                      for tid, d in zip(matched_tids, dets)}
        for j, d in zip(new_idx, u_det):
            det_of_tid[int(self.track_id[j])] = int(orig_idx[d])

        out = np.flatnonzero((self.state == CONFIRMED)
                             & (self.time_since_update <= 1))
        self.last_det_indices = [det_of_tid.get(int(self.track_id[r]), -1)
                                 for r in out]
        return self._views(out)


# ---------------------------------------------------------------------------
# MOTDT (Chen et al. 2018)
# ---------------------------------------------------------------------------

# MOTDT row lifecycle
MD_TRACKED, MD_LOST = 1, 2


def _nms_boxes(boxes: np.ndarray, scores: np.ndarray, thr: float):
    """Greedy NMS, returns kept indices (inclusive-pixel IoU)."""
    order = np.argsort(-scores)
    keep = []
    while len(order):
        i = order[0]
        keep.append(int(i))
        if len(order) == 1:
            break
        iou = matching.inclusive_iou_np(
            boxes[i:i + 1].astype(np.float32),
            boxes[order[1:]].astype(np.float32))[0]
        order = order[1:][iou <= thr]
    return np.asarray(keep, int)


class OnlineTracker(_AppearanceTable):
    """MOTDT: candidate selection (detections ∪ Kalman-propagated tracks)
    followed by appearance association with motion gating, IoU fallback,
    and lost-track re-identification.

    Two-phase per frame, because every candidate (including the propagated
    ones) needs an appearance embedding and the caller owns the embedding
    network:

        cand_boxes, cand_scores, from_det = trk.propose(det_boxes, det_scores)
        feats = <embed each candidate box>          # one batched device call
        views = trk.update(cand_boxes, cand_scores, from_det, feats)

    Defaults are the published MOTDT ones (min_cls_score 0.4, appearance
    radius min_ap_dist 0.64, 30-frame lost buffer, candidate NMS 0.3).
    """

    def __init__(self, min_cls_score=0.4, min_ap_dist=0.64, max_time_lost=30,
                 use_tracking=True, use_refind=True, nms_thresh=0.3,
                 ema_alpha=0.9):
        self.min_cls_score = float(min_cls_score)
        self.min_ap_dist = float(min_ap_dist)
        self.max_time_lost = int(max_time_lost)
        self.use_tracking = bool(use_tracking)
        self.use_refind = bool(use_refind)
        self.nms_thresh = float(nms_thresh)
        self.ema_alpha = float(ema_alpha)
        self.frame_id = 0
        self._init_table()
        self.activated = np.zeros((0,), bool)
        self.smooth_feat = np.zeros((0, 0), np.float32)

    def _keep_rows(self, mask: np.ndarray) -> None:
        super()._keep_rows(mask)
        self.activated = self.activated[mask]
        self.smooth_feat = self.smooth_feat[mask]

    def propose(self, det_boxes, det_scores):
        """Build the per-frame candidate set: detections plus (if
        use_tracking) the Kalman-predicted boxes of currently-tracked
        activated rows, scored by the rows' decayed last scores; joint NMS;
        min_cls_score floor. Also advances the Kalman table one frame."""
        self.frame_id += 1
        det_boxes = np.asarray(det_boxes, np.float64).reshape(-1, 4)
        det_scores = np.asarray(det_scores, np.float64).reshape(-1)

        # one predict per frame, lost rows freeze their h-velocity
        self.time_since_update += 1
        if len(self.mean):
            m = self.mean.copy()
            m[self.state == MD_LOST, 7] = 0.0
            self.mean, self.cov = self.kf.multi_predict(m, self.cov)

        boxes, scores, from_det = det_boxes, det_scores, \
            np.ones(len(det_boxes), bool)
        if self.use_tracking:
            rows = np.flatnonzero((self.state == MD_TRACKED) & self.activated)
            if len(rows):
                tboxes = _mean_to_tlbr(self.mean[rows])
                # propagated-candidate score: the track's last detection
                # score decayed per missed frame
                tscores = self.score[rows] * np.exp(
                    -0.1 * np.maximum(self.time_since_update[rows] - 1, 0))
                boxes = np.concatenate([boxes, tboxes])
                scores = np.concatenate([scores, tscores])
                from_det = np.concatenate(
                    [from_det, np.zeros(len(rows), bool)])

        good = scores > self.min_cls_score
        boxes, scores, from_det = boxes[good], scores[good], from_det[good]
        if len(boxes):
            keep = _nms_boxes(boxes, scores, self.nms_thresh)
            boxes, scores, from_det = boxes[keep], scores[keep], from_det[keep]
        return boxes, scores, from_det

    def _ema_update(self, rows, feats) -> None:
        if len(rows) == 0:
            return
        if self.smooth_feat.shape[1] != feats.shape[1]:
            self.smooth_feat = np.zeros(
                (len(self.state), feats.shape[1]), np.float32)
        a = self.ema_alpha
        blended = a * self.smooth_feat[rows] + (1 - a) * feats
        self.smooth_feat[rows] = _normalize(blended)

    def update(self, boxes, scores, from_det, feats) -> list:
        boxes = np.asarray(boxes, np.float64).reshape(-1, 4)
        scores = np.asarray(scores, np.float64).reshape(-1)
        from_det = np.asarray(from_det, bool).reshape(-1)
        feats = _normalize(np.asarray(feats).reshape(len(boxes), -1)) \
            if len(boxes) else np.zeros((0, 1), np.float32)
        if len(self.state) and self.smooth_feat.shape[1] != feats.shape[1] \
                and len(feats):
            self.smooth_feat = np.zeros(
                (len(self.state), feats.shape[1]), np.float32)

        # stage A: appearance association over tracked + lost, motion-gated
        pool = np.flatnonzero((self.state == MD_TRACKED)
                              | (self.state == MD_LOST))
        if len(pool) and len(boxes) and self.smooth_feat.shape[1] == \
                feats.shape[1]:
            cost = (1.0 - self.smooth_feat[pool] @ feats.T).astype(np.float64)
        else:
            cost = np.zeros((len(pool), len(boxes)), np.float64)
        cost = self._gate_cost(cost, pool, boxes)
        m, u_pool, u_cand = matching.linear_assignment(cost, self.min_ap_dist)
        matched_rows = [int(pool[a]) for a, _ in m]
        matched_cands = [int(b) for _, b in m]

        # stage B: leftover *tracked* rows vs leftover candidates by IoU
        rem_rows = np.asarray([int(pool[a]) for a in u_pool
                               if self.state[pool[a]] == MD_TRACKED], int)
        u_cand = np.asarray(u_cand, int)
        cost = 1.0 - matching.inclusive_iou_np(
            _mean_to_tlbr(self.mean[rem_rows]).astype(np.float32)
            if len(rem_rows) else np.zeros((0, 4), np.float32),
            boxes[u_cand].astype(np.float32))
        m2, u_rem, u_cand2 = matching.linear_assignment(
            cost.astype(np.float64), 0.5)
        matched_rows += [int(rem_rows[a]) for a, _ in m2]
        matched_cands += [int(u_cand[b]) for _, b in m2]
        u_cand = u_cand[list(u_cand2)]

        # apply matches: Kalman update, EMA appearance, refind lost rows
        rows = np.asarray(matched_rows, int)
        cands = np.asarray(matched_cands, int)
        if len(rows):
            refound = rows[self.state[rows] == MD_LOST]
            if not self.use_refind and len(refound):
                ok = self.state[rows] == MD_TRACKED
                rows, cands = rows[ok], cands[ok]
            self._kalman_update_rows(rows, boxes[cands], scores[cands])
            self.state[rows] = MD_TRACKED
            self.activated[rows] = True
            self._ema_update(rows, feats[cands])

        # unmatched tracked rows -> lost; expire old lost rows
        missed = np.ones(len(self.state), bool)
        if len(rows):
            missed[rows] = False
        self.state[missed & (self.state == MD_TRACKED)] = MD_LOST
        self._keep_rows(~((self.state == MD_LOST)
                          & (self.time_since_update > self.max_time_lost)))

        # new rows only from unmatched *detection* candidates
        new = u_cand[from_det[u_cand]] if len(u_cand) else \
            np.zeros((0,), int)
        n_old = len(self.state)
        self._append_rows(boxes[new], scores[new], MD_TRACKED)
        self.activated = np.concatenate(
            [self.activated, np.full(len(new), self.frame_id == 1, bool)])
        c = feats.shape[1] if len(feats) else self.smooth_feat.shape[1]
        if self.smooth_feat.shape[1] != c:  # only on first real frame
            self.smooth_feat = np.zeros((n_old, c), np.float32)
        self.smooth_feat = np.concatenate(
            [self.smooth_feat,
             _normalize(feats[new]) if len(new)
             else np.zeros((0, c), np.float32)])

        out = np.flatnonzero((self.state == MD_TRACKED) & self.activated
                             & (self.time_since_update < 1))
        return self._views(out)
