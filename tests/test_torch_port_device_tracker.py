"""The port's on-device ByteTrack (unicorn_torch/tracker/device_tracker.py,
batched over streams) against the JAX package's (tracker/jax_tracker.py), on
the CPU: the two assignment routines on crowded IoU-shaped costs with ties,
the auction against scipy's Hungarian solver, the Kalman steps, and
tracker_step frame by frame over a synthetic clip."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from unicorn_torch.tracker import device_tracker as dt
from unicorn_tpu.tracker import jax_tracker as jt


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _detection_stream(n_frames=40, n_obj=6, seed=0):
    """The synthetic clip of tests/test_torch_port_mot.py (kept here too, so
    that this file imports no model code): moving boxes with jitter,
    dropouts, low-score frames, a crossing pair and clutter, with classes."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(50, 400, (n_obj, 2))
    vel = rng.uniform(-5, 5, (n_obj, 2))
    vel[1] = (pos[0] - pos[1]) / 20.0      # object 1 crosses object 0
    size = rng.uniform(30, 80, (n_obj, 2))
    cls = rng.randint(0, 3, n_obj)
    for t in range(n_frames):
        boxes, scores, classes = [], [], []
        for i in range(n_obj):
            if rng.rand() < 0.1:           # missed detection
                continue
            tl = pos[i] + t * vel[i] + rng.randn(2) * 1.5
            boxes.append(np.r_[tl, tl + size[i]])
            scores.append(rng.choice([0.95, 0.8, 0.4, 0.2]))
            classes.append(cls[i])
        for _ in range(rng.randint(0, 3)):  # clutter
            tl = rng.uniform(0, 450, 2)
            boxes.append(np.r_[tl, tl + rng.uniform(20, 60, 2)])
            scores.append(rng.uniform(0.05, 0.7))
            classes.append(rng.randint(0, 3))
        yield (np.asarray(boxes, np.float64).reshape(-1, 4),
               np.asarray(scores), np.asarray(classes))


def _iou_np(a, b):
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(br - tl + 1, 0, None), -1)
    area = lambda x: np.prod(np.clip(x[:, 2:] - x[:, :2] + 1, 0, None), -1)
    return inter / (area(a)[:, None] + area(b)[None] - inter + 1e-9)


def _crowded_cost(seed, R=24, C=20, ties=True):
    """An association problem as a crowded frame gives it: overlapping
    tracks in clusters, detections that are jittered copies of some tracks
    plus clutter, some detections duplicated exactly and the costs rounded
    to two decimals so that whole rows and columns tie; some rows and
    columns invalid."""
    rng = np.random.RandomState(seed)
    centres = rng.uniform(100, 300, (4, 2))
    tl = centres[rng.randint(0, 4, R)] + rng.uniform(-40, 40, (R, 2))
    tracks = np.concatenate([tl, tl + rng.uniform(40, 80, (R, 2))], 1)
    src = rng.permutation(R)[:C]
    dets = tracks[src] + rng.randn(C, 4) * 3.0
    dets[-3:] = rng.uniform(0, 400, (3, 4))           # clutter
    dets[-3:, 2:] = dets[-3:, :2] + 50
    if ties:
        dets[1] = dets[0]                              # duplicate detections
        dets[5] = dets[4]
    cost = 1.0 - _iou_np(tracks, dets)
    if ties:
        cost = np.round(cost, 2)
    row_valid = rng.rand(R) > 0.15
    col_valid = rng.rand(C) > 0.1
    return cost.astype(np.float32), row_valid, col_valid


def _check_matching(match, cost, row_valid, col_valid, thresh):
    """One-to-one, only valid pairs, only pairs under the cost limit."""
    rows = np.nonzero(match >= 0)[0]
    cols = match[rows]
    assert len(set(cols.tolist())) == len(cols)
    assert row_valid[rows].all() and col_valid[cols].all()
    assert (cost[rows, cols] < thresh).all()
    return float((thresh - cost[rows, cols]).sum())


@pytest.mark.parametrize("thresh", [0.9, 0.5])
@pytest.mark.parametrize("routine", ["auction", "greedy"])
def test_assignments_equal_jax_on_crowded_costs_with_ties(routine, thresh):
    """Three problems batched as three streams give, stream by stream, the
    JAX routine's matching: equal arrays, ties included."""
    problems = [_crowded_cost(seed) for seed in (0, 1, 2)]
    if routine == "auction":
        j_fn = jax.jit(functools.partial(jt.auction_assign, thresh=thresh))
        t_fn = functools.partial(dt.auction_assign, thresh=thresh)
    else:
        j_fn = jax.jit(functools.partial(jt.greedy_assign, thresh=thresh,
                                         n_iter=16))
        t_fn = functools.partial(dt.greedy_assign, thresh=thresh, n_iter=16)
    got = t_fn(*(torch.from_numpy(np.stack(a)) for a in zip(*problems)))
    assert got.dtype == torch.int32
    n_matched = 0
    for s, (cost, rv, cv) in enumerate(problems):
        want = np.asarray(j_fn(jnp.asarray(cost), jnp.asarray(rv),
                               jnp.asarray(cv)))
        np.testing.assert_array_equal(got[s].numpy(), want)
        _check_matching(want, cost, rv, cv, thresh)
        n_matched += int((want >= 0).sum())
        # one stream alone gives the same as that stream in the batch
        alone = t_fn(*(torch.from_numpy(a)[None] for a in (cost, rv, cv)))
        np.testing.assert_array_equal(alone[0].numpy(), want)
    assert n_matched >= 12


@pytest.mark.parametrize("thresh", [0.9, 0.5])
def test_auction_stops_per_round_and_per_stream(monkeypatch, thresh):
    """The two properties the kernel's loop (csrc/tracker_step.cu) relies
    on, on crowded costs with ties: reading the loop's condition after every
    round (AUCTION_BLOCK 1) gives the matchings of blocks of 8, and each
    stream stopped alone, after its own last bidding round, gives its
    matching in the batched loop, though the streams need different numbers
    of rounds."""
    problems = [_crowded_cost(seed, R=40, C=32) for seed in range(7, 12)]
    batch = [torch.from_numpy(np.stack(a)) for a in zip(*problems)]
    blocks = dt.auction_assign(*batch, thresh)
    monkeypatch.setattr(dt, "AUCTION_BLOCK", 1)
    assert torch.equal(dt.auction_assign(*batch, thresh), blocks)
    rounds = []
    for s, problem in enumerate(problems):
        r0 = dt.auction_stats["rounds"]
        alone = dt.auction_assign(*(torch.from_numpy(a)[None]
                                    for a in problem), thresh)
        rounds.append(dt.auction_stats["rounds"] - r0)
        assert torch.equal(alone[0], blocks[s]), s
    assert len(set(rounds)) > 1, rounds


@pytest.mark.parametrize("seed", [3, 4, 5, 6])
def test_auction_matches_hungarian_with_cost_limit(seed):
    """Against scipy: the auction's total of (thresh - cost) is within
    n * eps of the optimum of the cost-limited problem, and on costs without
    ties the matching itself is the Hungarian one."""
    thresh, eps = 0.9, 2e-4
    for ties in (False, True):
        cost, rv, cv = _crowded_cost(seed, ties=ties)
        n0 = dict(dt.auction_stats)
        match = dt.auction_assign(*(torch.from_numpy(a)[None]
                                    for a in (cost, rv, cv)), thresh)[0].numpy()
        assert dt.auction_stats["calls"] == n0["calls"] + 1
        assert dt.auction_stats["syncs"] > n0["syncs"]
        rounds = dt.auction_stats["rounds"] - n0["rounds"]
        assert rounds % dt.AUCTION_BLOCK == 0 and rounds > 0
        total = _check_matching(match, cost, rv, cv, thresh)
        benefit = np.where(rv[:, None] & cv[None, :],
                           np.maximum(thresh - cost.astype(np.float64), 0), 0)
        r, c = linear_sum_assignment(-benefit)
        best = benefit[r, c].sum()
        assert total >= best - len(cost) * eps - 1e-5, (total, best)
        if not ties:
            want = np.full(len(cost), -1)
            keep = benefit[r, c] > 0
            want[r[keep]] = c[keep]
            np.testing.assert_array_equal(match, want)


def test_kalman_steps_match_jax():
    rng = np.random.RandomState(7)
    meas = np.stack([rng.uniform(50, 400, 5), rng.uniform(50, 400, 5),
                     rng.uniform(0.3, 1.2, 5), rng.uniform(30, 120, 5)],
                    1).astype(np.float32)
    meas2 = (meas + rng.randn(5, 4) * [2, 2, 0.01, 2]).astype(np.float32)
    jm, jc = jax.vmap(jt.kalman_initiate)(jnp.asarray(meas))
    tm, tc = dt.kalman_initiate(torch.from_numpy(meas)[None])
    np.testing.assert_allclose(tm[0].numpy(), np.asarray(jm), rtol=1e-6)
    np.testing.assert_allclose(tc[0].numpy(), np.asarray(jc), rtol=1e-6)
    for _ in range(3):
        jm, jc = jax.vmap(jt.kalman_predict)(jm, jc)
        tm, tc = dt.kalman_predict(tm, tc)
        jm, jc = jax.vmap(jt.kalman_update)(jm, jc, jnp.asarray(meas2))
        tm, tc = dt.kalman_update(tm, tc, torch.from_numpy(meas2)[None])
    np.testing.assert_allclose(tm[0].numpy(), np.asarray(jm), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tc[0].numpy(), np.asarray(jc), rtol=1e-4,
                               atol=1e-6)
    boxes = dt.mean_to_tlbr(tm)
    np.testing.assert_allclose(boxes[0].numpy(),
                               np.asarray(jt.mean_to_tlbr(jm)), rtol=1e-5)
    np.testing.assert_allclose(
        dt.xyxy_to_xyah(boxes)[0].numpy(),
        np.asarray(jt.xyxy_to_xyah(jt.mean_to_tlbr(jm))), rtol=1e-5)
    np.testing.assert_allclose(
        dt.iou_xyxy(boxes, boxes + 3.0, inclusive=True)[0].numpy(),
        np.asarray(jt.iou_xyxy(jt.mean_to_tlbr(jm), jt.mean_to_tlbr(jm) + 3.0,
                               inclusive=True)), rtol=1e-5)


def _padded(stream_frame, D):
    boxes, scores, _ = stream_frame
    n = len(boxes)
    dets = np.zeros((D, 5), np.float32)
    dets[:n, :4], dets[:n, 4] = boxes, scores
    valid = np.zeros(D, bool)
    valid[:n] = True
    return dets, valid


INT_FIELDS = ("state", "activated", "track_id", "last_frame", "start_frame",
              "next_id", "frame_id")


@pytest.mark.parametrize("kw,n_obj", [
    (dict(), 6),
    (dict(track_thresh=0.5, match_thresh=0.8, max_time_lost=5), 6),
    (dict(), 20),                                  # crowded: longer auctions
])
def test_tracker_step_matches_jax_frame_by_frame(kw, n_obj):
    """40 frames of the MOT test's synthetic clip (jitter, dropouts,
    low-score frames, a crossing pair, clutter): after every frame every
    integer and boolean field of the state equals the JAX tracker's, the
    Kalman means of live slots agree within 1e-3 px, and the emitted rows
    (valid mask, ids, scores, boxes) agree."""
    T, D = 64, 32
    ts_j = jt.init_state(T)
    ts_t = dt.init_state(T, device="cpu")
    emitted = 0
    for frame in _detection_stream(n_frames=40, n_obj=n_obj, seed=0):
        dets, valid = _padded(frame, D)
        ts_j, out_j, ov_j = jt.tracker_step(ts_j, jnp.asarray(dets),
                                            jnp.asarray(valid), **kw)
        ts_t, out_t, ov_t = dt.tracker_step(
            ts_t, torch.from_numpy(dets)[None], torch.from_numpy(valid)[None],
            **kw)
        for name in INT_FIELDS:
            np.testing.assert_array_equal(
                getattr(ts_t, name)[0].numpy(), np.asarray(getattr(ts_j, name)),
                err_msg=f"{name} at frame {int(ts_j.frame_id)}")
        live = np.asarray(ts_j.state) != jt.S_EMPTY
        np.testing.assert_allclose(ts_t.mean[0].numpy()[live],
                                   np.asarray(ts_j.mean)[live], atol=1e-3)
        np.testing.assert_allclose(ts_t.score[0].numpy()[live],
                                   np.asarray(ts_j.score)[live], atol=1e-6)
        ov = np.asarray(ov_j)
        np.testing.assert_array_equal(ov_t[0].numpy(), ov)
        np.testing.assert_array_equal(out_t[0].numpy()[ov, 5],
                                      np.asarray(out_j)[ov, 5])
        np.testing.assert_allclose(out_t[0].numpy()[ov, :5],
                                   np.asarray(out_j)[ov, :5], atol=1e-3)
        emitted += int(ov.sum())
    assert emitted > 100 and int(ts_j.next_id) > n_obj


def test_three_streams_batched_equal_three_single_streams():
    T, D, S = 32, 16, 3
    streams = [list(_detection_stream(n_frames=25, n_obj=5, seed=s))
               for s in (1, 2, 3)]
    batched = dt.init_state(T, n_streams=S, device="cpu")
    singles = [dt.init_state(T, device="cpu") for _ in range(S)]
    assert batched.mean.shape == (S, T, 8) and batched.next_id.shape == (S,)
    for t in range(25):
        padded = [_padded(streams[s][t], D) for s in range(S)]
        dets = torch.from_numpy(np.stack([p[0] for p in padded]))
        valid = torch.from_numpy(np.stack([p[1] for p in padded]))
        batched, out, ov = dt.tracker_step(batched, dets, valid)
        for s in range(S):
            singles[s], out_s, ov_s = dt.tracker_step(
                singles[s], dets[s:s + 1], valid[s:s + 1])
            assert torch.equal(ov[s], ov_s[0])
            torch.testing.assert_close(out[s], out_s[0], rtol=1e-6, atol=1e-5)
            for name in INT_FIELDS:
                assert torch.equal(getattr(batched, name)[s],
                                   getattr(singles[s], name)[0]), name
    assert int(batched.next_id.min()) > 5


def test_greedy_switch_reads_the_jax_packages_variable(monkeypatch):
    monkeypatch.delenv("UNICORN_ASSIGN", raising=False)
    assert dt._assign_fn() is dt.auction_assign
    monkeypatch.setenv("UNICORN_ASSIGN", "greedy")
    cost, rv, cv = _crowded_cost(8)
    args = [torch.from_numpy(a)[None] for a in (cost, rv, cv)]
    assert torch.equal(dt._assign_fn()(*args, 0.9),
                       dt.greedy_assign(*args, 0.9, 16))
    # equal costs: two rows tied for one column stay one to one
    ones = torch.ones(1, 2, dtype=torch.bool)
    m = dt.greedy_assign(torch.tensor([[[0.2, 0.9], [0.2, 0.9]]]), ones, ones,
                         0.5, 16)
    assert sorted(m[0].tolist()) == [-1, 0]


@pytest.mark.cuda
def test_tracker_step_on_the_card_equals_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    T, D = 64, 32
    ts_c = dt.init_state(T, device="cpu")
    ts_g = dt.init_state(T, device="cuda")
    for frame in _detection_stream(n_frames=40, n_obj=20, seed=0):
        dets, valid = (torch.from_numpy(a)[None] for a in _padded(frame, D))
        ts_c, out_c, ov_c = dt.tracker_step(ts_c, dets, valid)
        ts_g, out_g, ov_g = dt.tracker_step(ts_g, dets.cuda(), valid.cuda())
        assert torch.equal(ov_g.cpu(), ov_c)
        assert torch.equal(out_g.cpu()[..., 5], out_c[..., 5])
        assert torch.equal(ts_g.track_id.cpu(), ts_c.track_id)
