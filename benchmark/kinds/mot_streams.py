"""Multi-camera MOT serving, closed loop: S independent camera streams on
one card, a tick being one frame of every stream.

Set-up: the program's Unicorn (the configuration's exp and fields), one
deployed model for every camera, with the traffic file's `weights_seed`
draw of weights made on the card (the tracker's load follows the weights,
whose head biases the configuration's `prior_raise` sets to a published
density of people a frame, PERF.md); `MultiStreamMOT` with the pipeline
arguments of the traffic file; and a ring of `ring` synthetic uint8 frames
per stream (moving rectangles on a textured background, made on the card
from --seed, longer than the tracker's buffer) held in page-locked host
memory. --seed also draws the ticks the check samples. Each tick: upload
the S frames, letterbox them on the card (`letterbox_batch_device`),
`MultiStreamMOT.tick`, fetch the (S, T, 7) tracks. Warm-up ticks, then the tracker states are reset and the
window runs ticks for --seconds; the next tick starts when the last one's
tracks are on the host.

End to end: `frames_per_s` (S x ticks over the window's seconds),
`frame_latency_p95_ms` (the 95th percentile over every tick of the window,
from the hand-over of its host frames to its tracks on the host),
`setup_s` (process start to the first timed tick).

With --trace 1 the first third of --seconds runs as above (its rate feeds
the model's share of the peak), then `profile_ticks` ticks run the same
way under the profiler, then `timed_ticks` ticks time the stages apart (a
synchronise around each).

Correct: after the window, with the program freed, the plain reference
(benchmark/reference/) checks each stage of what the window produced:
- `letterbox_off_share`: of a sample of ticks (reservoir-drawn from the
  seed), the share of letterboxed values more than half a level from the
  reference's letterbox of the same host frames;
- `head_rel_err`: on the same ticks, the largest over the head's six
  outputs (reg, obj, cls and their SOT twins) of the relative L2 distance,
  over every level and sampled tick, between the program's forward and the
  fp32 reference's forward of the reference's letterbox;
- `nms_rows_off`: on the same ticks, the share of the (S, D) detection rows
  of the program that differ from the reference's decode and NMS of the
  program's head outputs (the stage's own input);
- `tracker_rows_off`: the share of the program's track rows, over every
  tick of the window, that differ from the reference tracker's, run from
  the empty state over the program's detections of every tick.
The last two follow the program stage by stage from its own outputs; the
first two check the stages before them from the inputs alone.
"""
from __future__ import annotations

import math
import random
import statistics
import sys
import time

import torch

from benchmark import flops, harness, synth, weights
from benchmark import trace as tracing
from benchmark.reference import model as ref_model
from benchmark.reference import postprocess as ref_post
from benchmark.reference import tracker as ref_tracker
from benchmark.reference.precision import QUANTISERS

HEAD_KEYS = ("reg", "obj", "cls", "reg_sot", "obj_sot", "cls_sot")


def _auction_stats() -> dict:
    """The device tracker's own counters (auction calls, rounds, host
    synchronisations), which the program keeps since they were set to 0."""
    from unicorn_torch.tracker import device_tracker

    return device_tracker.auction_stats


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_program(cell, seed, device):
    """(exp, MultiStreamMOT) of the cell on `device`, weights from the
    seed."""
    from unicorn_torch.drivers.stream import MultiStreamMOT

    exp = harness.program_exp(cell.cfg)
    model = harness.program_model(exp, device, serve=True)
    weights.load_seeded(model, seed, cell.cfg["prior_raise"])
    tr = cell.traffic
    pl = tr["pipeline"]
    mot = MultiStreamMOT(
        model, tr["streams"], device=device, input_size=exp.test_size,
        num_classes=exp.num_classes, conf_thre=exp.test_conf,
        nms_thre=exp.nmsthre, max_dets=pl["max_dets"],
        max_tracks=pl["max_tracks"], track_thresh=pl["track_thresh"],
        match_thresh=pl["match_thresh"], n_cand=pl["n_cand"],
        track_buffer=pl["track_buffer"], approx_topk=False)
    return exp, mot


def frame_ring(cell, seed, device):
    """(R, S, H, W, 3) uint8 host frames (page-locked on a card): a clip a
    stream, made from `seed`."""
    tr = cell.traffic
    H, W = tr["frame_hw"]
    vid, _ = synth.video(tr["streams"], tr["ring"], H, W, tr["objects"],
                         tr["object_px"], tr["speed_px"], seed, device)
    ring = torch.empty((tr["ring"], tr["streams"], H, W, 3),
                       dtype=torch.uint8, pin_memory=device.type == "cuda")
    ring.copy_(vid.transpose(0, 1))
    return ring


class Recorder:
    """Keeps what the program's stages produced: the detections of every
    tick (references, no copy) and, on the ticks the reservoir keeps, the
    letterboxed frames and the head's outputs. With `timed`, the detect and
    associate stages are synchronised and timed."""

    def __init__(self, mot, keep: int, seed: int, device):
        self.pipe = mot.pipe
        self.device = device
        self.rng = random.Random(seed)
        self.keep = keep
        self.dets = []                 # (dets5, valid) a tick
        self.sample = {}               # slot -> (tick, host ring index,
        self.slot = None               #          letterbox, head outputs)
        self.timed = False
        self.spans = {"detect": [], "associate": []}
        self._detect = self.pipe.detect
        self._associate = self.pipe.associate
        self._forward = self.pipe.model.forward_whole
        self.pipe.detect = self.detect
        self.pipe.associate = self.associate
        self.pipe.model.forward_whole = self.forward_whole

    def restore(self):
        del self.pipe.detect, self.pipe.associate
        del self.pipe.model.forward_whole

    def choose(self, tick: int):
        """The reservoir's slot for this tick, or None (a warm-up tick,
        numbered below 0, never has one)."""
        if tick < 0:
            self.slot = None
        elif tick < self.keep:
            self.slot = tick
        else:
            j = self.rng.randrange(tick + 1)
            self.slot = j if j < self.keep else None
        return self.slot

    def _span(self, name, fn, *a):
        if not self.timed:
            return fn(*a)
        _sync(self.device)
        t0 = time.perf_counter()
        with torch.profiler.record_function(tracing.LABEL + name):
            out = fn(*a)
        _sync(self.device)
        self.spans[name].append((time.perf_counter() - t0) * 1e3)
        return out

    def forward_whole(self, imgs):
        raw, feat = self._forward(imgs)
        if self.slot is not None:
            self.head = [{k: o[k] for k in HEAD_KEYS} for o in raw]
        return raw, feat

    def detect(self, frames):
        dets = self._span("detect", self._detect, frames)
        self.dets.append(dets)
        return dets

    def associate(self, dets5, valid):
        return self._span("associate", self._associate, dets5, valid)


def run(cell, args, device, start_wall):
    from unicorn_torch.ops.letterbox import letterbox_batch_device

    tr = cell.traffic
    S = tr["streams"]
    t_b = time.time()
    exp, mot = build_program(cell, tr["weights_seed"], device)
    t_r = time.time()
    ring = frame_ring(cell, args.seed, device)
    t_w = time.time()
    R = ring.shape[0]
    in_hw = tuple(exp.test_size)
    rec = Recorder(mot, tr["check_ticks"], args.seed, device)
    tracks, lat = [], []
    pre_ms = []

    def tick(i, timed=False):
        rec.timed = timed
        slot = rec.choose(i)
        t0 = time.perf_counter()
        host = ring[i % R]
        with torch.profiler.record_function(tracing.LABEL + "preprocess"):
            frames = letterbox_batch_device(
                host.to(device, non_blocking=True), in_hw)
        if timed:
            _sync(device)
            pre_ms.append((time.perf_counter() - t0) * 1e3)
        out = mot.tick(frames)
        with torch.profiler.record_function(tracing.LABEL + "fetch"):
            rows = out.cpu()
        t1 = time.perf_counter()
        if slot is not None:
            rec.sample[slot] = (i, i % R, frames, rec.head)
        return rows, t1 - t0

    for i in range(tr["warmup_ticks"]):
        tick(-1 - i)
    _sync(device)
    mot.pipe.reset()
    rec.dets.clear()
    auction = _auction_stats()
    counts0 = dict(auction)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.time() - start_wall
    print(f"set-up: {t_b - start_wall:.3f} s to the kind, program "
          f"{t_r - t_b:.3f} s, frames {t_w - t_r:.3f} s, warm-up "
          f"{time.time() - t_w:.3f} s", file=sys.stderr)
    t_start = time.perf_counter()
    i = 0

    def ticks_until(seconds=None, n=None, timed=False):
        nonlocal i
        done = 0
        while (time.perf_counter() - t_start < seconds if n is None
               else done < n):
            rows, dt = tick(i, timed)
            tracks.append(rows)
            lat.append(dt)
            i += 1
            done += 1

    plain_ticks = plain_end = None
    prof_box, prof_window = {}, 0.0
    if not args.trace:
        ticks_until(args.seconds)
    else:
        # the first third as the window runs (its rate), then a profiled
        # stretch run the same way, then ticks with their stages timed
        ticks_until(args.seconds / 3)
        plain_ticks, plain_end = i, time.perf_counter() - t_start
        with tracing.profiled(device.type == "cuda") as prof_box:
            p0 = time.perf_counter()
            ticks_until(n=tr["profile_ticks"])
            prof_window = time.perf_counter() - p0
        ticks_until(n=tr["timed_ticks"], timed=True)
    window_s = time.perf_counter() - t_start
    counts = {k: auction[k] - counts0[k] for k in auction}
    n_ticks = i
    peak_window = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    memory_peak = peak_window
    rec.restore()

    e2e = {"frames_per_s": S * n_ticks / window_s,
           "frame_latency_p95_ms": statistics.quantiles(
               [x * 1e3 for x in lat], n=20)[18],
           "setup_s": setup_s}
    half = len(lat) // 2
    print(f"mot_streams: {n_ticks} ticks of {S} frames in {window_s:.3f} s; "
          f"latency samples {len(lat)}; frames/s of the halves "
          f"{S * half / sum(lat[:half]):.2f}, "
          f"{S * (len(lat) - half) / sum(lat[half:]):.2f}; auction "
          f"{counts}; setup {setup_s:.3f} s; a frame: "
          f"{load(rec.dets, tracks, tr['pipeline']['track_thresh'])}",
          flush=True)

    layer_ctx = None
    if args.trace:
        layer_ctx = {
            "spans": {"preprocess": pre_ms, **rec.spans},
            "trace": tracing.reduce(prof_box.get("events", []), prof_window),
            "rate": ({"frames_per_s": S * plain_ticks / plain_end}
                     if plain_ticks else {}),
            "flops_per_frame": flops.serve_flops_per_frame(cell.cfg),
            "peak_mem_bytes_window": peak_window,
            "counters": dict(counts, ticks=n_ticks),
            "exp": cell.cfg["exp_fields"], "batch": S, "mode": "serve",
        }

    # the program's outputs the check reads; then the program goes
    dets = [(d.float(), v) for d, v in rec.dets]
    sample = [rec.sample[k] for k in sorted(rec.sample)]
    del mot, rec
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = check(cell, device, ring, sample, dets, tracks, in_hw)
    return {"attempted": n_ticks * S, "failed": 0, "e2e": e2e,
            "checks": checks, "memory_peak_bytes": memory_peak,
            "layer_ctx": layer_ctx}


def load(dets, tracks, track_thresh) -> str:
    """The tracker's load over the window, a frame on average: detections,
    those above `track_thresh` (ByteTrack's first association), and the
    tracks it put out."""
    if not dets:
        return "no ticks"
    valid = torch.stack([v for _, v in dets])
    score = torch.stack([d[..., 4].float() for d, _ in dets])
    out = torch.stack([(t[..., 6] > 0).sum(-1) for t in tracks])
    return (f"detections {float(valid.sum(-1).float().mean()):.2f}, high "
            f"{float((valid & (score > track_thresh)).sum(-1).float().mean()):.2f}"
            f", tracks {float(out.float().mean()):.2f}")


def reference_model(cell, device, q_main="exact"):
    """The plain reference of the served model, the same weights."""
    m = ref_model.build(cell.cfg["exp_fields"], device, remat=False)
    weights.load_seeded(m, cell.traffic["weights_seed"],
                        cell.cfg["prior_raise"])
    q = QUANTISERS[q_main]
    ref_model.set_quantisers(m, q, q)
    return m.eval()


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def rows_off(a, av, b, bv, tol=1e-3):
    """Rows (..., 5+) differing between (a, valid av) and (b, valid bv): a
    valid flag that differs, or a valid row more than tol (1 + |b|) off in
    any column."""
    far = ((a - b).abs() > tol * (1 + b.abs())).any(-1)
    return int(((av != bv) | (av & bv & far)).sum())


@torch.no_grad()
def check(cell, device, ring, sample, dets, tracks, in_hw):
    """[(name, value, limit)] of the stages' comparisons (module
    docstring)."""
    exp = cell.cfg["exp_fields"]
    lim = cell.limits
    tr = cell.traffic
    pl = tr["pipeline"]
    off = total = 0
    nms_off = nms_total = 0
    ref = reference_model(cell, device)
    sq = {k: [0.0, 0.0] for k in HEAD_KEYS}     # sum (p - r)^2, sum r^2
    for _, r_idx, frames, head in sample:
        host = ring[r_idx].to(device)
        ref_lb = ref_post.letterbox(host, in_hw)
        off += int(((frames.float() - ref_lb).abs() > 0.5).sum())
        total += ref_lb.numel()
        ref_head = ref.forward_whole(ref_lb.permute(0, 3, 1, 2))
        for p_lv, r_lv in zip(head, ref_head):
            for k in HEAD_KEYS:
                r = r_lv[k].double()
                sq[k][0] += float((p_lv[k].double() - r).square().sum())
                sq[k][1] += float(r.square().sum())
    per_key = {k: math.sqrt(d / max(n, 1e-300)) for k, (d, n) in sq.items()}
    head_err = max(per_key.values()) if sample else 1.0
    del ref
    # decode + NMS on the program's head outputs, against its detections
    for t_idx, _, _, head in sample:
        d_ref, v_ref = ref_post.nms(
            ref_post.decode(head), exp["num_classes"], exp["test_conf"],
            exp["nmsthre"], pl["n_cand"], pl["max_dets"], cluster_iters=8)
        d_p, v_p = dets[t_idx]
        nms_off += rows_off(d_p, v_p, d_ref, v_ref)
        nms_total += v_ref.numel()
    t_off, t_total = tracker_off(dets, tracks, pl, device)
    print("head_rel_err by output: " + ", ".join(
        f"{k} {v:.4g}" for k, v in per_key.items()), file=sys.stderr)
    return [
        ("letterbox_off_share", off / max(total, 1),
         lim["letterbox_off_share"]),
        ("head_rel_err", head_err, lim["head_rel_err"]),
        ("nms_rows_off", nms_off / max(nms_total, 1), lim["nms_rows_off"]),
        ("tracker_rows_off", t_off / max(t_total, 1),
         lim["tracker_rows_off"]),
    ]


def tracker_off(dets, tracks, pl, device, q=None):
    """(rows off, rows compared) of the reference tracker over `dets` from
    the empty state against the program's `tracks` (S, T, 7) a tick."""
    S = dets[0][0].shape[0]
    ts = ref_tracker.init_state(pl["max_tracks"], S, device)
    off = total = 0
    for (d, v), rows in zip(dets, tracks):
        ts, out, ov = ref_tracker.tracker_step(
            ts, d.to(device), v.to(device), pl["track_thresh"],
            pl["match_thresh"], pl["track_buffer"], q=q)
        out, ov = out.cpu(), ov.cpu()
        pv = rows[..., 6] > 0
        off += rows_off(rows[..., :6], pv, out, ov)
        total += int((pv | ov).sum())
    return off, total
