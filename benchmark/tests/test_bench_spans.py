"""The readers of the program's spans (benchmark/spans.py and the metric
files that use it), fed synthetic span records: each gives the median over
the roots of its measure, self times and the backward's union come out as
computed by hand, and an empty record, or none, reads None. On the card
(marked `cuda`), a short --trace 1 run of mot.tiny.s8: the serving span
metrics read numbers, and no device event of the profiled stretch carries a
span's name (the program's ranges are not mirrored onto the device)."""
from __future__ import annotations

import argparse
import os
import time

import pytest

from benchmark import harness, spans

SERVE = ("model.forward_host_ms", "postprocess.host_ms",
         "tracker.dispatch_ms", "tracker.sync_wait_ms")
TRAIN = ("train.forward_host_ms", "loss.simota_host_ms",
         "train.backward_host_ms", "train.optimizer_host_ms")


class Rec:
    def __init__(self, name, parent, root, start_ms, end_ms, thread):
        self.name, self.parent, self.root = name, parent, root
        self.start_ns = int(start_ms * 1e6)
        self.end_ns = None if end_ms is None else int(end_ms * 1e6)
        self.thread = thread


class Records:
    """Records in opening order, each root's index its own."""

    def __init__(self):
        self.recs = []

    def add(self, name, start, end, parent=-1, thread=1):
        i = len(self.recs)
        root = i if parent < 0 else self.recs[parent].root
        self.recs.append(Rec(name, parent, root, start, end, thread))
        return i


def _read(metric, recs):
    path = os.path.join(harness.BENCH, "metrics", metric + ".py")
    return harness.load_module(path).read({"span_records": recs})


def _tick(b, t0, forward, post, syncs, step):
    """A tick at t0 ms: the forward, decode + NMS taking `post` ms, the
    tracker step of `step` ms holding sync waits `syncs`."""
    tick = b.add("mot.tick", t0, t0 + 200)
    det = b.add("mot.detect", t0, t0 + 100, tick)
    fw = b.add("model.forward", t0, t0 + forward, det)
    b.add("model.trunk", t0, t0 + forward / 2, fw)
    b.add("postprocess.decode", t0 + 90, t0 + 90 + post / 2, det)
    b.add("postprocess.nms", t0 + 95, t0 + 95 + post / 2, det)
    asc = b.add("mot.associate", t0 + 100, t0 + 190, tick)
    st = b.add("tracker.step", t0 + 100, t0 + 100 + step, asc)
    b.add("tracker.predict", t0 + 100, t0 + 101, st)
    m = b.add("tracker.match", t0 + 101, t0 + 150, st)
    a = b.add("tracker.auction", t0 + 102, t0 + 149, m)
    t = t0 + 103
    for w in syncs:
        b.add("tracker.sync", t, t + w, a)
        b.add("tracker.round", t + w, t + w + 1, a)
        t += w + 1
    b.add("tracker.update", t0 + 150, t0 + 160, st)


def test_serving_readers():
    b = Records()
    b.add("preprocess.letterbox", 0, 5)
    _tick(b, 10, forward=50, post=8, syncs=(2, 3), step=60)
    b.add("preprocess.letterbox", 300, 305)
    _tick(b, 310, forward=70, post=4, syncs=(1,), step=40)
    _tick(b, 610, forward=60, post=6, syncs=(4, 4, 1), step=80)
    b.add("mot.tick", 900, None)          # open: left out
    got = {m: _read(m, b.recs) for m in SERVE}
    want = {"model.forward_host_ms": 60, "postprocess.host_ms": 6,
            "tracker.sync_wait_ms": 5,
            # tracker.step less its syncs: 55, 39, 71
            "tracker.dispatch_ms": 55}
    for m in SERVE:
        assert got[m] == pytest.approx(want[m], abs=1e-6), m
    for m in TRAIN:
        assert _read(m, b.recs) is None, m


def _step(b, t0, forward, simota, backward, engine, optimizer, ema):
    st = b.add("train.step", t0, t0 + 500)
    fw = b.add("train.forward", t0, t0 + forward, st)
    b.add("model.trunk", t0, t0 + forward / 2, fw)
    for k, ms in enumerate(simota):
        b.add("loss.simota", t0 + forward / 2 + 10 * k,
              t0 + forward / 2 + 10 * k + ms, fw)
    b0 = t0 + forward
    bw = b.add("train.backward", b0, b0 + backward, st)
    for s, e in engine:          # roots on the autograd engine's thread
        b.add("op.correlation_train.bwd", b0 + s, b0 + e, thread=2)
    o0 = b0 + backward
    op = b.add("train.optimizer", o0, o0 + optimizer, st)
    b.add("train.ema", o0 + optimizer - ema, o0 + optimizer, op)
    return bw, op


def test_training_readers_and_self_time():
    b = Records()
    _, op0 = _step(b, 0, forward=100, simota=(3, 4), backward=150,
                   engine=[(10, 20), (140, 170)], optimizer=40, ema=5)
    _step(b, 1000, forward=120, simota=(5, 1), backward=130,
          engine=[(5, 6)], optimizer=30, ema=10)
    _step(b, 2000, forward=80, simota=(2, 2), backward=160, engine=[],
          optimizer=50, ema=8)
    b.add("op.correlation_train.bwd", 2900, 2990, thread=2)   # no step's
    got = {m: _read(m, b.recs) for m in TRAIN}
    # backward: 150 + the 20 ms the second engine range runs past it, 130,
    # 160; the engine ranges inside it count once
    want = {"train.forward_host_ms": 100, "loss.simota_host_ms": 6,
            "train.backward_host_ms": 160, "train.optimizer_host_ms": 40}
    for m in TRAIN:
        assert got[m] == pytest.approx(want[m], abs=1e-6), m
    for m in SERVE:
        assert _read(m, b.recs) is None, m
    assert spans.self_ms(b.recs, op0) == pytest.approx(35, abs=1e-6)
    assert spans.self_ms(b.recs, 1) == pytest.approx(100 - 50 - 7, abs=1e-6)
    assert spans.union_ms([(0, 2_000_000), (1_000_000, 3_000_000),
                           (5_000_000, 6_000_000)]) == pytest.approx(4.0)


def test_empty_or_absent_records_read_none():
    for m in SERVE + TRAIN:
        assert _read(m, []) is None, m
        assert _read(m, None) is None, m
    from unicorn_torch.utils import profiling
    profiling.clear_spans()
    assert spans.records({}) == []
    for m in SERVE + TRAIN:
        path = os.path.join(harness.BENCH, "metrics", m + ".py")
        assert harness.load_module(path).read({}) is None, m


@pytest.mark.cuda
def test_traced_serving_run_mirrors_no_span(monkeypatch):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from benchmark import trace as tracing
    from unicorn_torch.utils import profiling

    kept = {}
    reduce = tracing.reduce

    def keep(events, window_s):
        kept["events"] = list(events)
        return reduce(events, window_s)

    monkeypatch.setattr(tracing, "reduce", keep)
    profiling.clear_spans()
    cell = harness.Cell("mot.tiny.s8", harness.manifest())
    args = argparse.Namespace(workload=cell.name, seed=2147483004,
                              seconds=6.0, trace=1)
    out = cell.kind().run(cell, args, device=torch.device("cuda", 0),
                          start_wall=time.time())
    names = {r.name for r in profiling.spans()}
    assert {"mot.tick", "tracker.sync", "model.forward"} <= names
    device = {e.name for e in kept["events"]
              if e.device_type == torch.autograd.DeviceType.CUDA}
    assert any(n.startswith(tracing.LABEL) for n in device)  # mirrors show
    assert not names & device, names & device
    for m in SERVE:
        assert cell.reader(m).read(out["layer_ctx"]) is not None, m
