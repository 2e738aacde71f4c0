"""The port's spans (unicorn_torch/utils/profiling.py `span`) on the CPU.

- With no profiler on, a span is the one shared null context and nothing is
  recorded, whatever runs.
- Under a CPU torch.profiler, one tick of a tiny MultiStreamMOT (the JAX
  stream tests' CSPDarknet 0.33 / 0.25 Unicorn at 64x64, 3 streams, the
  obj / cls biases raised by 6 so that tracks form) records the tree
  mot.tick > mot.detect > model.forward > model.trunk / model.neck /
  model.head, postprocess.decode, postprocess.nms; mot.associate >
  tracker.step > tracker.predict, three tracker.match (> tracker.auction >
  tracker.sync, tracker.round), tracker.update; the letterbox before it is
  a root of its own. One tiny uni step records train.step > train.forward
  (> model spans, loss.sot_priors, loss.uni > loss.simota), train.backward,
  train.optimizer > train.ema. Every record's parent and root agree with
  the nesting.
- Every span event in prof.events() is a CPU op that is not a user
  annotation (the profiler mirrors user annotations onto the device's
  timeline, where they would count as device work).
- The tracker.sync spans number as many as auction_stats["syncs"] grew.
- Detections, track rows, losses and gradients are bit-equal with tracing
  on and off.
- A span opened on another thread roots a tree of its own; the training
  correlation Function's forward and backward open op.correlation_train
  and op.correlation_train.bwd (on the plain ops here); the records stop at
  MAX_SPANS and count the rest; trace() starts the records empty.
"""
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from unicorn_torch.core import train_state as tts
from unicorn_torch.core.train_step import make_uni_train_step
from unicorn_torch.drivers.stream import MultiStreamMOT
from unicorn_torch.models.unicorn import Unicorn
from unicorn_torch.ops import correlation_kernel as ck
from unicorn_torch.ops.letterbox import letterbox_batch_device
from unicorn_torch.tracker import device_tracker
from unicorn_torch.utils import profiling

H = W = 64
TINY = dict(backbone_name="csp_darknet", depth=0.33, width=0.25,
            in_channels=(256, 512, 1024), interact_mode="conv",
            n_layer_att=0, use_attention=False)
KW = dict(input_size=(H, W), num_classes=1, conf_thre=0.3, nms_thre=0.65,
          track_thresh=0.5, max_dets=16, max_tracks=16, n_cand=32)
S = 3
TICKS = 3


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    profiling.clear_spans()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _serving_model():
    m = Unicorn(num_classes=1, **TINY,
                generator=torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name.startswith(("head.obj_preds.", "head.cls_preds.")) \
                    and name.endswith(".bias"):
                p += 6.0
    return m


def _clips():
    """(TICKS, S, H + 16, W + 24, 3) uint8: a panning texture a stream, a
    size that the letterbox scales."""
    rng = np.random.RandomState(5)
    out = []
    for s in range(S):
        base = (rng.rand(H + 16, W + 24 + 3 * TICKS, 3) * 255).astype(
            np.uint8)
        out.append(np.stack([base[:, 3 * t:3 * t + W + 24]
                             for t in range(TICKS)]))
    return torch.from_numpy(np.stack(out, 1))


def _serve(model, profiled_ticks):
    """Ticks of a fresh MultiStreamMOT: the letterbox, then the tick; the
    ticks in `profiled_ticks` under a CPU profiler. Returns (detections,
    track rows, the last profiler, the auction's syncs in it)."""
    mot = MultiStreamMOT(model, S, device="cpu", **KW)
    dets, detect = [], mot.pipe.detect

    def recorded(frames):
        out = detect(frames)
        dets.append(out)
        return out

    mot.pipe.detect = recorded
    rows, prof, syncs = [], None, None
    for t, clip in enumerate(_clips()):
        if t in profiled_ticks:
            s0 = device_tracker.auction_stats["syncs"]
            with _cpu_profile() as prof:
                rows.append(mot.tick(letterbox_batch_device(clip, (H, W))))
            syncs = device_tracker.auction_stats["syncs"] - s0
        else:
            rows.append(mot.tick(letterbox_batch_device(clip, (H, W))))
    return dets, rows, prof, syncs


def _tree(recs):
    """[(depth, name)] in opening order, with each record's parent and
    root checked against the nesting."""
    out = []
    for i, r in enumerate(recs):
        depth, j = 0, r.parent
        while j >= 0:
            assert j < i
            depth, j = depth + 1, recs[j].parent
        if r.parent < 0:
            assert r.root == i
        else:
            assert r.root == recs[r.parent].root
            p = recs[r.parent]
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns
        assert r.end_ns is not None and r.thread == recs[r.root].thread
        out.append((depth, r.name))
    return out


def _collapse(tree):
    """The tree with runs of the same (depth, name) as one entry."""
    out = []
    for x in tree:
        if not out or out[-1] != x:
            out.append(x)
    return out


def test_no_profiler_records_nothing():
    assert profiling.span("a") is profiling.span("b")
    with profiling.span("a"):
        pass
    _serve(_serving_model(), profiled_ticks=())
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_tick_span_tree_and_no_user_annotations():
    _, _, prof, syncs = _serve(_serving_model(), profiled_ticks=(TICKS - 1,))
    recs = profiling.spans()
    tree = _tree(recs)
    assert tree[0] == (0, "preprocess.letterbox")
    tick = _collapse(tree[1:])
    head = [(0, "mot.tick"), (1, "mot.detect"), (2, "model.forward"),
            (3, "model.trunk"), (3, "model.neck"), (3, "model.head"),
            (2, "postprocess.decode"), (2, "postprocess.nms"),
            (1, "mot.associate"), (2, "tracker.step"),
            (3, "tracker.predict")]
    assert tick[:len(head)] == head
    assert tick[-1] == (3, "tracker.update")
    matches = [i for i, x in enumerate(tick) if x == (3, "tracker.match")]
    assert len(matches) == 3 and matches[0] == len(head)
    for i, j in zip(matches, matches[1:] + [len(tick) - 1]):
        assert tick[i + 1] == (4, "tracker.auction")
        assert set(tick[i + 2:j]) <= {(5, "tracker.sync"),
                                      (5, "tracker.round")}
        assert tick[i + 2] == (5, "tracker.sync")
    assert (5, "tracker.round") in tick
    n_sync = sum(r.name == "tracker.sync" for r in recs)
    assert syncs > 0 and n_sync == syncs
    names = {r.name for r in recs}
    events = [e for e in prof.events() if e.name in names]
    assert {e.name for e in events} == names
    assert len(events) == len(recs)
    for e in events:
        assert not e.is_user_annotation, e.name
        assert e.device_type == torch.autograd.DeviceType.CPU, e.name


def test_serving_bit_equal_with_tracing_on_and_off():
    model = _serving_model()
    d_off, r_off, _, _ = _serve(model, profiled_ticks=())
    d_on, r_on, _, _ = _serve(model, profiled_ticks=range(TICKS))
    assert sum(r.name == "mot.tick" for r in profiling.spans()) == TICKS
    assert int(sum((r[..., 6] > 0).sum() for r in r_off)) > 0
    for (a, av), (b, bv) in zip(d_off, d_on):
        assert torch.equal(a, b) and torch.equal(av, bv)
    for a, b in zip(r_off, r_on):
        assert torch.equal(a, b)


TRAIN_CFG = dict(num_classes=8, **TINY)
LOSS_KW = dict(use_l1=True, num_classes=8, mhs=True)


def _train_batch():
    """2 pairs: a SOT pair of one box, a MOT pair of 3 boxes."""
    rng = np.random.RandomState(0)
    images = torch.from_numpy(
        (rng.rand(2, 2, 3, H, W) * 255).astype(np.float32))
    targets = torch.zeros(2, 2, 6, 6)
    for b, n in enumerate((1, 3)):
        cxy = torch.from_numpy(rng.uniform(0.3, 0.7, (n, 2)) * [W, H])
        wh = torch.from_numpy(rng.uniform(12, 40, (n, 2)))
        for f in range(2):
            targets[b, f, :n, 0] = torch.from_numpy(
                rng.randint(0, 8, n).astype(np.float32)) if b else 0
            targets[b, f, :n, 1:3] = cxy + f
            targets[b, f, :n, 3:5] = wh
            targets[b, f, :n, 5] = torch.arange(1, n + 1)
    return images, targets, torch.tensor([1, 2])


def _train_step(profiled):
    """A fresh seeded tiny Unicorn's uni step -> (losses, gradients,
    weights and EMA after the update)."""
    model = Unicorn(**TRAIN_CFG, generator=torch.Generator().manual_seed(0))
    tx = tts.make_optimizer(lambda c: 1e-3, kind="adamw", weight_decay=5e-4,
                            no_decay_mask_fn=tts.default_wd_mask)
    state = tts.TrainState.create(model.train(), tx, device="cpu")
    grads, apply = {}, state.apply_gradients

    def capture():
        grads.update({n: p.grad.detach().clone()
                      for n, p in state.model.named_parameters()
                      if p.grad is not None})
        return apply()

    state.apply_gradients = capture
    step = make_uni_train_step((H, W), **LOSS_KW)
    if profiled:
        with _cpu_profile() as prof:
            _, losses = step(state, *_train_batch())
    else:
        prof = None
        _, losses = step(state, *_train_batch())
    return (losses, grads, dict(state.model.state_dict()),
            dict(state.ema_model.state_dict()), prof)


def test_train_step_span_tree_and_bit_equal():
    off = _train_step(False)
    assert profiling.spans() == []
    on = _train_step(True)
    tree = _collapse(_tree(profiling.spans()))
    top = [x for x in tree if x[0] <= 1]
    assert top == [(0, "train.step"), (1, "train.forward"),
                   (1, "train.backward"), (1, "train.optimizer")]
    fwd = tree[2:tree.index((1, "train.backward"))]
    assert fwd[:7] == [(2, "model.trunk"), (2, "model.neck"),
                       (2, "model.interaction"), (2, "loss.sot_priors"),
                       (2, "model.head"), (2, "loss.uni"),
                       (3, "loss.simota")]
    assert set(fwd) == {(2, "model.trunk"), (2, "model.neck"),
                        (2, "model.interaction"), (2, "loss.sot_priors"),
                        (2, "model.head"), (2, "loss.uni"),
                        (3, "loss.simota")}
    assert tree[-1] == (2, "train.ema")
    names = {r.name for r in profiling.spans()}
    for e in on[4].events():
        if e.name in names:
            assert not e.is_user_annotation, e.name
    for a, b in zip(off[:4], on[:4]):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_threads_op_ranges_bound_and_trace(tmp_path, monkeypatch):
    g = torch.Generator().manual_seed(1)
    e0 = torch.randn(1, 20, 6, generator=g, requires_grad=True)
    e1 = torch.randn(1, 20, 6, generator=g, requires_grad=True)
    v = torch.rand(1, 2, 20, generator=g, requires_grad=True)
    plain = (ck.correlation_fwd_lse_plain, ck.correlation_bwd_i_plain,
             ck.correlation_bwd_j_plain)
    with _cpu_profile():
        with profiling.span("outer"):
            out = ck.propagate_train_grouped(e0, e1, v, ops=plain)
            out.square().sum().backward()
            t = threading.Thread(target=lambda: profiling.span(
                "other").__enter__().__exit__(None, None, None))
            t.start()
            t.join()
    recs = profiling.spans()
    assert [(r.name, r.parent) for r in recs] == [
        ("outer", -1), ("op.correlation_train", 0),
        ("op.correlation_train.bwd", 0), ("other", -1)]
    assert recs[3].root == 3 and recs[3].thread != recs[0].thread
    monkeypatch.setattr(profiling, "MAX_SPANS", 2)
    profiling.clear_spans()
    with _cpu_profile():
        for _ in range(5):
            with profiling.span("x"):
                pass
    assert len(profiling.spans()) == 2 and profiling.dropped() == 3
    monkeypatch.undo()
    with profiling.trace(str(tmp_path / "trace")):
        with profiling.span("y"):
            pass
    assert [r.name for r in profiling.spans()] == ["y"]
    assert profiling.dropped() == 0
