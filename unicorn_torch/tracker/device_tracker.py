"""On-device ByteTrack: the association step as batched tensor code over
fixed track slots (port of unicorn_tpu/tracker/jax_tracker.py).

The whole tracker state (Kalman means and covariances, the slot table) is a
`TrackState` of tensors on one device; one `tracker_step` call consumes one
frame's padded detections and nothing is fetched to the host in between.
Every function here is batched over a leading stream axis S: S = 1 is the
single stream, S > 1 takes the place of the JAX package's `vmap` over
streams, whose tracker states never mix.

Association uses a parallel (Jacobi) auction with the objective of the host
tracker's Hungarian solver, so device and host ids agree on crowded frames;
the two-stage BYTE logic (high/low split, unconfirmed handling, lost buffer)
is that of tracker/byte_tracker.py.

Two forms of the step, one result. On CUDA tensors `tracker_step` is one
launch of csrc/tracker_step.cu (`tracker_step_cuda`): a thread block a
stream runs the whole step, the auctions looping on the card until no row
can bid, as the JAX version's `while_loop` does, so a frame holds no host
synchronisation. On CPU tensors it is `tracker_step_plain`, eager tensor
code whose auction reads its loop condition on the host between blocks of
rounds; the CPU tests hold it against the JAX package, and the card tests
hold the kernel against it.

Ties: every argmax here takes the first maximum (`torch.argmax`), as
`jnp.argmax` does; one flipped tie would change ids for the rest of a
stream. Scatters repeat an index only on a scratch slot that is dropped.
"""
from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple

import torch

from ..utils.profiling import span, spanned

# slot states
S_EMPTY, S_TRACKED, S_LOST = 0, 1, 2

# auction rounds run between two reads of the loop's condition
AUCTION_BLOCK = 8

# host-side counts since they were last set to 0: the plain auction's calls,
# rounds run and reads of the loop condition (each a host synchronisation
# on the card, and a `tracker.sync` span), and the steps the kernel ran
# (`fused_steps`, one launch of csrc/tracker_step.cu each; the kernel path
# leaves the other three at 0). Read by the benchmark's serving kind
# (benchmark/kinds/mot_streams.py) for `tracker.syncs_per_tick` and
# `tracker.fused_steps_per_tick`, and by chip_smoke.py
auction_stats = {"calls": 0, "rounds": 0, "syncs": 0, "fused_steps": 0}

# the kernel's limits (csrc/tracker_step.cu MAX_T, MAX_D)
MAX_TRACKS = 1024
MAX_DETS = 1024


class TrackState(NamedTuple):
    mean: torch.Tensor         # (S, T, 8) cx, cy, a, h + velocities
    cov: torch.Tensor          # (S, T, 8, 8)
    state: torch.Tensor        # (S, T) int32: 0 empty / 1 tracked / 2 lost
    activated: torch.Tensor    # (S, T) bool
    track_id: torch.Tensor     # (S, T) int32
    score: torch.Tensor        # (S, T)
    last_frame: torch.Tensor   # (S, T) int32, frame of the last update
    start_frame: torch.Tensor  # (S, T) int32
    next_id: torch.Tensor      # (S,) int32
    frame_id: torch.Tensor     # (S,) int32


def init_state(max_tracks: int = 128, n_streams: int = 1,
               device="cuda") -> TrackState:
    S, T = n_streams, max_tracks
    dev = torch.device(device)

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(*shape, dtype=dtype, device=dev)

    return TrackState(
        mean=zeros(S, T, 8), cov=zeros(S, T, 8, 8),
        state=zeros(S, T, dtype=torch.int32),
        activated=zeros(S, T, dtype=torch.bool),
        track_id=zeros(S, T, dtype=torch.int32), score=zeros(S, T),
        last_frame=zeros(S, T, dtype=torch.int32),
        start_frame=zeros(S, T, dtype=torch.int32),
        next_id=torch.ones(S, dtype=torch.int32, device=dev),
        frame_id=zeros(S, dtype=torch.int32),
    )


# ---------------- Kalman (batched over leading axes) ------------------------

_STD_POS = 1.0 / 20
_STD_VEL = 1.0 / 160


def _motion_mat(like: torch.Tensor) -> torch.Tensor:
    m = torch.eye(8, dtype=like.dtype, device=like.device)
    m[torch.arange(4), torch.arange(4) + 4] = 1.0
    return m


def _stds(h: torch.Tensor, factors) -> torch.Tensor:
    """(...,) heights -> (..., len(factors)) standard deviations: a number
    scales h, a (None, c) pair is the constant c."""
    return torch.stack([f * h if not isinstance(f, tuple)
                        else torch.full_like(h, f[1]) for f in factors], -1)


def kalman_initiate(meas: torch.Tensor):
    """meas (..., 4) cxcyah -> (mean (..., 8), cov (..., 8, 8))."""
    h = meas[..., 3]
    mean = torch.cat([meas, torch.zeros_like(meas)], -1)
    std = _stds(h, (2 * _STD_POS, 2 * _STD_POS, (None, 1e-2), 2 * _STD_POS,
                    10 * _STD_VEL, 10 * _STD_VEL, (None, 1e-5),
                    10 * _STD_VEL))
    return mean, torch.diag_embed(std ** 2)


def kalman_predict(mean: torch.Tensor, cov: torch.Tensor):
    h = mean[..., 3]
    std = _stds(h, (_STD_POS, _STD_POS, (None, 1e-2), _STD_POS,
                    _STD_VEL, _STD_VEL, (None, 1e-5), _STD_VEL))
    Fm = _motion_mat(mean)
    mean_p = (Fm @ mean[..., None])[..., 0]
    return mean_p, Fm @ cov @ Fm.T + torch.diag_embed(std ** 2)


def kalman_update(mean: torch.Tensor, cov: torch.Tensor, meas: torch.Tensor):
    """One measurement update per slot; a 4x4 system is solved per slot in
    fp32. A slot with a singular system (an empty slot: zero covariance)
    gets non-finite values, which the caller masks out."""
    h = mean[..., 3]
    std = _stds(h, (_STD_POS, _STD_POS, (None, 1e-1), _STD_POS))
    Hm = torch.eye(4, 8, dtype=mean.dtype, device=mean.device)
    S = Hm @ cov @ Hm.T + torch.diag_embed(std ** 2)
    K = torch.linalg.solve_ex(S, Hm @ cov)[0].transpose(-1, -2)  # (..., 8, 4)
    innov = meas - (Hm @ mean[..., None])[..., 0]
    return (mean + (K @ innov[..., None])[..., 0],
            cov - K @ S @ K.transpose(-1, -2))


def mean_to_tlbr(mean: torch.Tensor) -> torch.Tensor:
    """(..., 8) cxcyah -> (..., 4) tlbr."""
    cx, cy, a, h = mean[..., 0], mean[..., 1], mean[..., 2], mean[..., 3]
    w = a * h
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def xyxy_to_xyah(b: torch.Tensor) -> torch.Tensor:
    w = b[..., 2] - b[..., 0]
    h = b[..., 3] - b[..., 1]
    return torch.stack([
        (b[..., 0] + b[..., 2]) / 2, (b[..., 1] + b[..., 3]) / 2,
        w / h.clamp_min(1e-6), h,
    ], -1)


# ---------------- assignment -----------------------------------------------

def _owner_to_match(owner: torch.Tensor, n_rows: int) -> torch.Tensor:
    """owner (S, C) row-per-column -> match (S, R) column-per-row, -1 where
    a row owns no column. Columns without an owner write to a scratch row."""
    S, C = owner.shape
    m = torch.full((S, n_rows + 1), -1, dtype=torch.int32, device=owner.device)
    idx = torch.where(owner >= 0, owner, n_rows).long()
    cols = torch.arange(C, dtype=torch.int32, device=owner.device)
    m.scatter_(1, idx, cols.expand(S, C))
    return m[:, :n_rows]


@spanned("tracker.auction")
def auction_assign(cost, row_valid, col_valid, thresh, eps: float = 2e-4,
                   max_iter: int = 20000):
    """Optimal assignment with a cost limit by a parallel (Jacobi) auction,
    batched: cost (S, R, C), row_valid (S, R), col_valid (S, C) -> match_col
    (S, R) int32, -1 = unmatched.

    Maximises sum(thresh - cost) over the matching, the objective of
    lapjv(extend_cost=True, cost_limit=thresh) and of the host tracker's
    Hungarian solver: a pair is worth matching iff cost < thresh. All
    unassigned rows bid at once each round; the result is within n * eps of
    optimal, and eps = 2e-4 reproduces the Hungarian matchings on IoU-shaped
    tracking costs.

    The JAX version loops on the device until no row can improve. Here the
    host reads the loop's condition (one flag: does any row of any stream
    still want to bid) before each block of AUCTION_BLOCK rounds, so an
    auction without bidders costs one read and no round. A round after
    convergence changes nothing (no bidder, so no price and no owner moves),
    for one stream as for all of them, so the matching is the JAX loop's;
    rounds are never capped below what the data needs (max_iter is the JAX
    version's). This is the plain form's auction; the kernel
    (csrc/tracker_step.cu) runs the same rounds on the card, each stream
    stopping when its own rows stop bidding."""
    NEG = -1e9
    S, R, C = cost.shape
    dev = cost.device
    benefit = torch.where(row_valid[:, :, None] & col_valid[:, None, :],
                          thresh - cost, torch.full_like(cost, NEG))
    price = torch.zeros(S, C, dtype=cost.dtype, device=dev)
    owner = torch.full((S, C), -1, dtype=torch.int32, device=dev)
    cols = torch.arange(C, device=dev)
    neg = torch.full((), NEG, dtype=cost.dtype, device=dev)

    def wants(price, owner):
        match = _owner_to_match(owner, R)
        value = benefit - price[:, None, :]
        return (match < 0) & row_valid & (value.amax(2) > 0)

    auction_stats["calls"] += 1
    it = 0
    while it < max_iter:
        auction_stats["syncs"] += 1
        bidders = wants(price, owner).any()
        with span("tracker.sync"):
            if not bool(bidders):
                break
        n_rounds = min(AUCTION_BLOCK, max_iter - it)
        for _ in range(n_rounds):
            with span("tracker.round"):
                value = benefit - price[:, None, :]              # (S, R, C)
                match = _owner_to_match(owner, R)
                j1 = value.argmax(2)                             # best column
                v1 = value.gather(2, j1[..., None])[..., 0]
                # the second-best alternative includes "stay unassigned"
                # (value 0), the cost limit's dummy column
                v2 = value.scatter(2, j1[..., None], NEG).amax(2).clamp_min(
                    0.0)
                bidder = (match < 0) & row_valid & (v1 > 0)
                bid = price.gather(1, j1) + (v1 - v2) + eps
                bidmat = torch.where(
                    bidder[..., None] & (j1[..., None] == cols),
                    bid[..., None], neg)
                col_best = bidmat.amax(1)                        # (S, C)
                winner = bidmat.argmax(1).int()
                has_bid = col_best > NEG / 2
                price = torch.where(has_bid, col_best, price)
                # the loser is evicted
                owner = torch.where(has_bid, winner, owner)
        it += n_rounds
        auction_stats["rounds"] += n_rounds
    return _owner_to_match(owner, R)


def greedy_assign(cost, row_valid, col_valid, thresh, n_iter: int):
    """Global-minimum greedy assignment by parallel mutual-best elimination,
    batched like auction_assign: every (row, column) pair that is both its
    row's and its column's minimum is matched at once each round."""
    BIG = 1e9
    S, R, C = cost.shape
    dev = cost.device
    big = torch.full((), BIG, dtype=cost.dtype, device=dev)
    cost = torch.where(row_valid[:, :, None] & col_valid[:, None, :], cost,
                       big)
    match = torch.full((S, R), -1, dtype=torch.int32, device=dev)
    cols = torch.arange(C, device=dev)
    rows = torch.arange(R, device=dev)
    for _ in range(min(16, n_iter)):
        row_min = cost.amin(2, keepdim=True)
        col_min = cost.amin(1, keepdim=True)
        mutual = (cost <= row_min) & (cost <= col_min) & (cost < thresh)
        # ties inside a row: the first mutual column
        first_c = mutual.int().argmax(2)                          # (S, R)
        row_has = mutual.any(2) & (match < 0)
        # ties across rows: the first claiming row wins the column this
        # round, the loser contends again in a later one
        claims = row_has[..., None] & (cols == first_c[..., None])
        winner = claims.int().argmax(1)                           # (S, C)
        won = row_has & (winner.gather(1, first_c) == rows)
        match = torch.where(won, first_c.int(), match)
        col_taken = torch.zeros(S, C, dtype=torch.int32, device=dev)
        col_taken = col_taken.scatter_reduce(1, first_c, won.int(), "amax")
        cost = torch.where(won[..., None] | (col_taken > 0)[:, None, :], big,
                           cost)
    return match


def iou_xyxy(a, b, inclusive: bool = False):
    """(S, Ra, 4) x (S, Rb, 4) -> (S, Ra, Rb). inclusive=True is the +1
    inclusive-pixel convention of cython_bbox.bbox_overlaps, the reference's
    association IoU."""
    off = 1.0 if inclusive else 0.0
    tl = torch.maximum(a[:, :, None, :2], b[:, None, :, :2])
    br = torch.minimum(a[:, :, None, 2:], b[:, None, :, 2:])
    inter = (br - tl + off).clamp_min(0).prod(-1)
    area_a = (a[..., 2:] - a[..., :2] + off).clamp_min(0).prod(-1)
    area_b = (b[..., 2:] - b[..., :2] + off).clamp_min(0).prod(-1)
    return inter / (area_a[:, :, None] + area_b[:, None, :] - inter + 1e-9)


def _assign_fn():
    """The assignment in use: the auction (Hungarian-exact on tracking
    costs). UNICORN_ASSIGN=greedy, the variable the JAX package reads, swaps
    in the mutual-best form."""
    if os.environ.get("UNICORN_ASSIGN") == "greedy":
        return lambda c, rv, cv, th: greedy_assign(c, rv, cv, th, 16)
    return auction_assign


# ---------------- the per-frame step ----------------------------------------

def _mark(used: torch.Tensor, match: torch.Tensor) -> torch.Tensor:
    """used (S, D) bool with the detections that `match` (S, T) names set."""
    hit = match >= 0
    idx = torch.where(hit, match, 0).long()
    return used | (torch.zeros_like(used, dtype=torch.int32).scatter_reduce(
        1, idx, hit.int(), "amax") > 0)


def _place(dst, src, idx, mask):
    """dst (S, T, ...) with src (S, D, ...) written at slot idx (S, D) where
    mask; the others write to a scratch slot T that is dropped."""
    S, T = dst.shape[:2]
    idx_safe = torch.where(mask, idx, T).long()
    pad = torch.cat([dst, dst.new_zeros((S, 1) + dst.shape[2:])], 1)
    idx_safe = idx_safe.reshape(idx_safe.shape + (1,) * (src.dim() - 2))
    pad.scatter_(1, idx_safe.expand_as(src), src.to(dst.dtype))
    return pad[:, :T]


def _fused(device: torch.device) -> bool:
    """Whether `tracker_step` runs as the kernel: on a CUDA device, unless
    UNICORN_ASSIGN=greedy selects the mutual-best assignment, which only the
    plain form has."""
    return (device.type == "cuda"
            and os.environ.get("UNICORN_ASSIGN") != "greedy")


@torch.no_grad()
@spanned("tracker.step")
def tracker_step(ts: TrackState, dets, det_valid, track_thresh: float = 0.6,
                 match_thresh: float = 0.9, max_time_lost: int = 30,
                 det_thresh_offset: float = 0.1):
    """One BYTE association step per stream.

    dets (S, D, 5) [x1, y1, x2, y2, score] padded; det_valid (S, D) bool.
    Returns (new_state, out (S, T, 6) [x1, y1, x2, y2, score, track_id] of
    the slots that are tracked and activated, out_valid (S, T)).

    On CUDA tensors one launch of the kernel (`tracker_step_cuda`), with no
    host synchronisation; on CPU tensors, and on either device under
    UNICORN_ASSIGN=greedy (an assignment the kernel does not implement), the
    plain form `tracker_step_plain`."""
    if _fused(dets.device):
        return tracker_step_cuda(ts, dets, det_valid, track_thresh,
                                 match_thresh, max_time_lost,
                                 det_thresh_offset)
    return tracker_step_plain(ts, dets, det_valid, track_thresh,
                              match_thresh, max_time_lost, det_thresh_offset)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built kernel library with its C signature declared."""
    from ..csrc import build

    lib = build.load("tracker_step")
    lib.tracker_step_launch.argtypes = (
        [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_float] * 3
        + [ctypes.c_int, ctypes.c_void_p])
    lib.tracker_step_launch.restype = ctypes.c_int
    lib.tracker_step_error_string.argtypes = [ctypes.c_int]
    lib.tracker_step_error_string.restype = ctypes.c_char_p
    return lib


_rounds: dict = {}


def fused_rounds(device="cuda") -> torch.Tensor:
    """(3,) int64 on the device: the rounds the kernel's three auctions have
    run there since the process started, summed over streams (a round in
    which some row bid). The kernel adds to it; read it as a difference
    (a read synchronises)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev not in _rounds:
        _rounds[dev] = torch.zeros(3, dtype=torch.int64, device=dev)
    return _rounds[dev]


# each TrackState field's dtype and shape after (S, T) (None: (S,))
_FIELDS = TrackState(*[(torch.float32, (8,)), (torch.float32, (8, 8))]
                     + [(dt, ()) for dt in (
                         torch.int32, torch.bool, torch.int32, torch.float32,
                         torch.int32, torch.int32)]
                     + [(torch.int32, None)] * 2)


def _check(ts: TrackState, dets, det_valid):
    """Raise on what the kernel does not take."""
    if dets.dim() != 3 or dets.shape[2] != 5:
        raise ValueError(f"tracker_step_cuda: dets must be (S, D, 5), got "
                         f"{tuple(dets.shape)}")
    S, D = dets.shape[:2]
    T = ts.state.shape[-1]
    if not (S >= 1 and 1 <= T <= MAX_TRACKS and 1 <= D <= MAX_DETS):
        raise ValueError(f"tracker_step_cuda: S {S}, T {T}, D {D} outside "
                         f"the kernel's limits (S >= 1, 1 <= T <= "
                         f"{MAX_TRACKS}, 1 <= D <= {MAX_DETS})")
    want = [(dets, torch.float32, (S, D, 5), "dets"),
            (det_valid, torch.bool, (S, D), "det_valid")]
    for name, x, (dtype, tail) in zip(TrackState._fields, ts, _FIELDS):
        want.append((x, dtype, (S,) if tail is None else (S, T) + tail, name))
    for x, dtype, shape, name in want:
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"tracker_step_cuda: {name} must be {dtype} "
                             f"{shape}, got {x.dtype} {tuple(x.shape)}")
        if x.device != dets.device:
            raise ValueError(f"tracker_step_cuda: {name} is on {x.device}, "
                             f"dets on {dets.device}")


@torch.no_grad()
def tracker_step_cuda(ts: TrackState, dets, det_valid,
                      track_thresh: float = 0.6, match_thresh: float = 0.9,
                      max_time_lost: int = 30,
                      det_thresh_offset: float = 0.1):
    """`tracker_step_plain` as one launch of csrc/tracker_step.cu on
    PyTorch's current stream: the same arguments and results, on CUDA
    tensors of the dtypes `init_state` makes and float32 detections, with
    1 <= T <= MAX_TRACKS and 1 <= D <= MAX_DETS (it raises otherwise).
    Outputs and the (S, T, D) IoU scratch are allocated here; nothing is
    read back to the host."""
    _check(ts, dets, det_valid)
    S, D = dets.shape[:2]
    T = ts.state.shape[1]
    dev = dets.device
    src = [x.contiguous() for x in ts]
    new = TrackState(*[torch.empty_like(x) for x in src])
    out = torch.empty(S, T, 6, dtype=torch.float32, device=dev)
    out_valid = torch.empty(S, T, dtype=torch.bool, device=dev)
    iou = torch.empty(S, T, D, dtype=torch.float32, device=dev)
    tensors = (*src, dets.contiguous(), det_valid.contiguous(), *new, out,
               out_valid, iou, fused_rounds(dev))
    ptrs = (ctypes.c_void_p * len(tensors))(*[x.data_ptr() for x in tensors])
    lib = _lib()
    err = lib.tracker_step_launch(
        ptrs, S, T, D, track_thresh, match_thresh,
        track_thresh + det_thresh_offset, max_time_lost,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"tracker_step launch failed: {err} "
                           f"({lib.tracker_step_error_string(err).decode()})"
                           f" at S {S}, T {T}, D {D}")
    auction_stats["fused_steps"] += 1
    return new, out, out_valid


@torch.no_grad()
def tracker_step_plain(ts: TrackState, dets, det_valid,
                       track_thresh: float = 0.6, match_thresh: float = 0.9,
                       max_time_lost: int = 30,
                       det_thresh_offset: float = 0.1):
    """`tracker_step` as eager tensor code, on any device: the form the CPU
    runs and the kernel is held against."""
    S, T = ts.state.shape
    D = dets.shape[1]
    dev = dets.device
    frame_id = ts.frame_id + 1                                    # (S,)
    det_thresh = track_thresh + det_thresh_offset

    # Kalman predict for the tracked + lost pool (lost slots zero their
    # h-velocity first); unconfirmed slots keep their initiate-time mean and
    # covariance, as the reference predicts strack_pool only
    with span("tracker.predict"):
        lost = ts.state == S_LOST
        mean_in = ts.mean.clone()
        mean_in[..., 7] = torch.where(lost, torch.zeros_like(ts.score),
                                      ts.mean[..., 7])
        mean_p, cov_p = kalman_predict(mean_in, ts.cov)
        live = ts.state != S_EMPTY
        pool_pred = live & (ts.activated | lost)
        mean_p = torch.where(pool_pred[..., None], mean_p, ts.mean)
        cov_p = torch.where(pool_pred[..., None, None], cov_p, ts.cov)

    scores = dets[..., 4]
    high = det_valid & (scores > track_thresh)
    low = det_valid & (scores > 0.1) & (scores < track_thresh)
    track_boxes = mean_to_tlbr(mean_p)

    # association 1: activated-or-lost slots vs high dets, fused score
    assign = _assign_fn()
    with span("tracker.match"):
        pool1 = live & (ts.activated | lost)
        iou1 = iou_xyxy(track_boxes, dets[..., :4], inclusive=True)
        cost1 = 1.0 - iou1 * scores[:, None, :]
        match1 = assign(cost1, pool1, high, match_thresh)

    # association 2: remaining tracked slots vs low dets, plain IoU
    with span("tracker.match"):
        tracked = ts.state == S_TRACKED
        pool2 = live & tracked & ts.activated & (match1 < 0)
        match2 = assign(1.0 - iou1, pool2, low, 0.5)

    # association 3: unconfirmed (tracked, not activated) vs leftover high
    with span("tracker.match"):
        det_used = _mark(torch.zeros_like(det_valid), match1)
        pool3 = live & tracked & ~ts.activated
        match3 = assign(cost1, pool3, high & ~det_used, 0.7)

    with span("tracker.update"):
        match = torch.where(match1 >= 0, match1,
                            torch.where(match2 >= 0, match2, match3))
        matched = match >= 0
        det_idx = torch.where(matched, match, 0).long()
        picked = dets.gather(1, det_idx[..., None].expand(S, T, 5))
        meas = xyxy_to_xyah(picked[..., :4])

        mean_u, cov_u = kalman_update(mean_p, cov_p, meas)
        new_mean = torch.where(matched[..., None], mean_u, mean_p)
        new_cov = torch.where(matched[..., None, None], cov_u, cov_p)
        new_score = torch.where(matched, picked[..., 4], ts.score)
        new_activated = ts.activated | matched
        fid = frame_id[:, None].expand(S, T)
        new_last = torch.where(matched, fid, ts.last_frame)
        state = torch.where(matched, S_TRACKED, ts.state)

        # unmatched tracked -> lost; unmatched unconfirmed -> removed
        state = torch.where(live & tracked & ts.activated & ~matched, S_LOST,
                            state)
        state = torch.where(live & tracked & ~ts.activated & ~matched, S_EMPTY,
                            state)
        # expire lost
        expired = (state == S_LOST) & (fid - new_last > max_time_lost)
        state = torch.where(expired, S_EMPTY, state)

        # new tracks from unmatched strong dets; >= as the host tracker: a det
        # at exactly the threshold must start a track on both paths
        det_used = _mark(_mark(det_used, match2), match3)
        new_det = det_valid & (scores >= det_thresh) & high & ~det_used
        # det j -> the j-th free slot, by cumulative counts
        free = state == S_EMPTY
        free_rank = torch.cumsum(free.int(), 1) - 1
        det_rank = (torch.cumsum(new_det.int(), 1) - 1).int()
        slot_for_rank = torch.full((S, T + D), -1, dtype=torch.int32,
                                   device=dev)
        slot_idx = torch.where(free, free_rank, T + D - 1)
        slot_for_rank.scatter_(1, slot_idx, torch.arange(
            T, dtype=torch.int32, device=dev).expand(S, T))
        target_slot = slot_for_rank.gather(
            1, det_rank.clamp(0, T + D - 1).long())
        place = new_det & (target_slot >= 0)

        init_mean, init_cov = kalman_initiate(xyxy_to_xyah(dets[..., :4]))
        fid_d = frame_id[:, None].expand(S, D)
        new_mean = _place(new_mean, init_mean, target_slot, place)
        new_cov = _place(new_cov, init_cov, target_slot, place)
        new_score = _place(new_score, scores, target_slot, place)
        state = _place(state, torch.full_like(fid_d, S_TRACKED), target_slot,
                       place)
        new_activated = _place(new_activated, fid_d == 1, target_slot, place)
        new_last = _place(new_last, fid_d, target_slot, place)
        start = _place(ts.start_frame, fid_d, target_slot, place)
        n_new = place.sum(1).int()
        track_id = _place(ts.track_id, ts.next_id[:, None] + det_rank,
                          target_slot, place)

        # de-duplicate tracked vs lost (byte_tracker remove_duplicate): of an
        # overlapping (tracked, lost) pair (IoU > 0.85) the younger is dropped
        boxes_now = mean_to_tlbr(new_mean)
        is_t = state == S_TRACKED
        is_l = state == S_LOST
        dup = ((iou_xyxy(boxes_now, boxes_now, inclusive=True) > 0.85)
               & is_t[:, :, None] & is_l[:, None, :])
        age = new_last - start
        drop_t = (dup & (age[:, :, None] <= age[:, None, :])).any(2)
        drop_l = (dup & (age[:, :, None] > age[:, None, :])).any(1)
        state = torch.where(drop_t | drop_l, S_EMPTY, state)

        new_ts = TrackState(
            mean=new_mean, cov=new_cov, state=state, activated=new_activated,
            track_id=track_id, score=new_score, last_frame=new_last,
            start_frame=start, next_id=ts.next_id + n_new, frame_id=frame_id)
        out_valid = (state == S_TRACKED) & new_activated
        out = torch.cat([mean_to_tlbr(new_mean), new_score[..., None],
                         track_id[..., None].to(new_mean.dtype)], -1)
        return new_ts, out, out_valid
