"""A run with the timed path broken underneath comes out not correct, once
for each fault the cells can have: half of the batch left out, an answer
altered where it is produced (the detections; the tracks), a training
step that leaves its state unchanged, and one that leaves its EMA copy
unchanged. The harness runs on the CPU at a
small size, its look for a card skipped; the limits are the cells'."""
from __future__ import annotations

import pytest
import torch

from benchmark.control import FAULTS
from benchmark.tests.tiny import failed, run_cpu, tiny_cell


@pytest.fixture(scope="module")
def torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def test_mot_sound_run_numbers(torch_threads):
    out = run_cpu(tiny_cell("mot.tiny.s8"))
    got = {n: v for n, v, _ in out["checks"]}
    assert got["nms_rows_off"] == 0 and got["tracker_rows_off"] == 0
    assert got["letterbox_off_share"] < 0.05 and out["attempted"] > 0


def test_mot_half_batch_left_out(monkeypatch, torch_threads):
    from unicorn_torch.models.unicorn import Unicorn

    whole = Unicorn.forward_whole

    def half(self, imgs):
        n = imgs.shape[0] // 2
        raw, feat = whole(self, imgs[:n])
        twice = [{k: torch.cat([v, v]) for k, v in lv.items()} for lv in raw]
        return twice, torch.cat([feat, feat])

    monkeypatch.setattr(Unicorn, "forward_whole", half)
    assert "head_rel_err" in failed(run_cpu(tiny_cell("mot.tiny.s8")))


def test_mot_detections_altered(monkeypatch, torch_threads):
    from unicorn_torch.drivers import stream

    post = stream.postprocess_device

    def altered(*a, **kw):
        dets, valid = post(*a, **kw)
        return dets + 2.0 * valid[..., None], valid

    monkeypatch.setattr(stream, "postprocess_device", altered)
    assert "nms_rows_off" in failed(run_cpu(tiny_cell("mot.tiny.s8")))


def test_mot_tracks_altered(monkeypatch, torch_threads):
    from unicorn_torch.drivers import stream

    step = stream.tracker_step

    def altered(*a, **kw):
        ts, out, valid = step(*a, **kw)
        return ts, out + torch.tensor([3.0, 0, 0, 0, 0, 0]), valid

    monkeypatch.setattr(stream, "tracker_step", altered)
    assert "tracker_rows_off" in failed(run_cpu(tiny_cell("mot.tiny.s8")))


def test_train_state_left_unchanged(monkeypatch, torch_threads):
    monkeypatch.setattr(*FAULTS["unchanged"]())
    bad = failed(run_cpu(tiny_cell("train.large.b2")))
    assert bad.get("update_gap", 0) >= 0.99
    assert bad.get("grad_gap", 0) >= 0.99


def test_train_ema_left_unchanged(monkeypatch, torch_threads):
    monkeypatch.setattr(*FAULTS["ema_unchanged"]())
    bad = failed(run_cpu(tiny_cell("train.large.b2")))
    assert bad.get("ema_gap", 0) >= 0.99
    assert "update_gap" not in bad


def test_train_half_batch_left_out(monkeypatch, torch_threads):
    monkeypatch.setattr(*FAULTS["half_batch"]())
    bad = failed(run_cpu(tiny_cell("train.large.b2")))
    assert bad.get("simota_unfollowed") == 1
