"""The device tracker's step as one kernel (csrc/tracker_step.cu, through
unicorn_torch/tracker/device_tracker.py `tracker_step_cuda`) against its
plain form: on the card (marked `cuda`, skipped without one) frame by frame
over crowded clips (chip_smoke.py `crowded_clip`) at the serving cell's
shapes, and on the CPU the routing and the counters. This file imports no
JAX, so that the card tests run on a machine without it:

    python -m pytest --noconftest tests/test_torch_port_tracker_kernel.py -m cuda
"""
import pytest
import torch

from chip_smoke import TRACKER_INT_FIELDS as INT_FIELDS
from chip_smoke import crowded_clip
from unicorn_torch.tracker import device_tracker as dt

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def _assert_states_equal(a, b, where):
    for name in INT_FIELDS:
        assert torch.equal(getattr(a, name).cpu(), getattr(b, name).cpu()), (
            f"{name}, {where}")


@pytest.mark.cuda
def test_kernel_equals_the_plain_form_on_the_card():
    """60 crowded frames at S 8, T 256, D 256: valid masks, ids and every
    integer field of the state bit-equal to the plain form on the card,
    scores equal, boxes within 1e-4 px; the auctions converge (no step near
    the 20000-round cap) and the kernel path leaves the plain counters
    alone."""
    _need_card()
    S, T, D = 8, 256, 256
    dets, valid = crowded_clip(S, D)
    dets, valid = dets.cuda(), valid.cuda()
    ts_k = dt.init_state(T, S, device="cuda")
    ts_p = dt.init_state(T, S, device="cuda")
    steps0 = dt.auction_stats["fused_steps"]
    emitted = max_box = 0.0
    rounds = torch.zeros(3, dtype=torch.int64)
    for f in range(dets.shape[0]):
        plain0 = {k: dt.auction_stats[k] for k in ("calls", "rounds", "syncs")}
        rounds0 = dt.fused_rounds("cuda").cpu()
        ts_k, out_k, ov_k = dt.tracker_step(ts_k, dets[f], valid[f])
        stats = {k: dt.auction_stats[k] for k in plain0}
        assert stats == plain0, "the kernel path ran the plain auction"
        # summed over the streams: no auction of any stream met the cap
        step_rounds = dt.fused_rounds("cuda").cpu() - rounds0
        assert int(step_rounds.max()) < 20000, step_rounds
        rounds += step_rounds
        ts_p, out_p, ov_p = dt.tracker_step_plain(ts_p, dets[f], valid[f])
        assert torch.equal(ov_k, ov_p), f"valid mask, frame {f}"
        assert torch.equal(out_k[..., 5], out_p[..., 5]), f"ids, frame {f}"
        assert torch.equal(out_k[..., 4], out_p[..., 4]), f"scores, frame {f}"
        _assert_states_equal(ts_k, ts_p, f"frame {f}")
        d_box = (out_k[..., :4] - out_p[..., :4]).abs().max().item()
        max_box = max(max_box, d_box)
        assert d_box <= 1e-4, f"boxes {d_box} px off, frame {f}"
        emitted += int(ov_k.sum())
    n = dets.shape[0]
    assert dt.auction_stats["fused_steps"] - steps0 == n
    rounds = rounds.tolist()
    assert all(r > 0 for r in rounds), rounds
    assert emitted > 20 * S * n // 2, emitted
    assert int(ts_k.next_id.min()) > 31
    print(f"rounds a frame {[r / n for r in rounds]}, {emitted / n:.1f} "
          f"tracks a frame, boxes within {max_box:.3g} px")


@pytest.mark.cuda
def test_kernel_equals_the_cpu():
    """The kernel on the card against the plain form on the CPU, as
    chip_smoke.py holds the card's step: valid masks, ids and slot states
    equal frame by frame, boxes within 1e-2 px."""
    _need_card()
    S, T, D = 8, 256, 256
    dets, valid = crowded_clip(S, D, n_frames=20, seed=1)
    ts_c = dt.init_state(T, S, device="cpu")
    ts_g = dt.init_state(T, S, device="cuda")
    for f in range(dets.shape[0]):
        ts_c, out_c, ov_c = dt.tracker_step(ts_c, dets[f], valid[f])
        ts_g, out_g, ov_g = dt.tracker_step(ts_g, dets[f].cuda(),
                                            valid[f].cuda())
        assert torch.equal(ov_g.cpu(), ov_c), f"valid mask, frame {f}"
        assert torch.equal(out_g.cpu()[..., 5], out_c[..., 5]), f"ids, {f}"
        _assert_states_equal(ts_g, ts_c, f"frame {f}")
        d_box = (out_g.cpu()[ov_c][:, :4] - out_c[ov_c][:, :4]).abs()
        assert not len(d_box) or d_box.max().item() < 1e-2


@pytest.mark.cuda
def test_greedy_on_the_card_is_the_plain_form(monkeypatch):
    """Under UNICORN_ASSIGN=greedy card tensors take the plain form, which
    equals itself on the CPU (valid masks, ids, slot states; boxes within
    1e-2 px), and the kernel does not run."""
    _need_card()
    monkeypatch.setenv("UNICORN_ASSIGN", "greedy")
    S, T, D = 4, 128, 96
    dets, valid = crowded_clip(S, D, n_frames=20, n_obj=16, seed=2)
    ts_c = dt.init_state(T, S, device="cpu")
    ts_g = dt.init_state(T, S, device="cuda")
    steps0 = dt.auction_stats["fused_steps"]
    for f in range(dets.shape[0]):
        ts_c, out_c, ov_c = dt.tracker_step(ts_c, dets[f], valid[f])
        ts_g, out_g, ov_g = dt.tracker_step(ts_g, dets[f].cuda(),
                                            valid[f].cuda())
        assert torch.equal(ov_g.cpu(), ov_c), f"valid mask, frame {f}"
        assert torch.equal(out_g.cpu()[..., 5], out_c[..., 5]), f"ids, {f}"
        _assert_states_equal(ts_g, ts_c, f"frame {f}")
        d_box = (out_g.cpu()[ov_c][:, :4] - out_c[ov_c][:, :4]).abs()
        assert not len(d_box) or d_box.max().item() < 1e-2
    assert dt.auction_stats["fused_steps"] == steps0
    assert int(ov_c.sum()) > 0


@pytest.mark.cuda
def test_kernel_limits_raise():
    _need_card()
    dets, valid = crowded_clip(1, 8, n_frames=1, n_obj=2)
    with pytest.raises(ValueError, match="limits"):
        dt.tracker_step(dt.init_state(dt.MAX_TRACKS + 1, device="cuda"),
                        dets[0].cuda(), valid[0].cuda())
    big = torch.zeros(1, dt.MAX_DETS + 1, 5, device="cuda")
    with pytest.raises(ValueError, match="limits"):
        dt.tracker_step(dt.init_state(16, device="cuda"), big,
                        torch.zeros(1, dt.MAX_DETS + 1, dtype=torch.bool,
                                    device="cuda"))
    with pytest.raises(ValueError, match="dets"):
        dt.tracker_step(dt.init_state(16, device="cuda"),
                        dets[0].cuda().double(), valid[0].cuda())


def test_cpu_tensors_take_the_plain_form(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the kernel ran on CPU tensors")

    monkeypatch.setattr(dt, "tracker_step_cuda", refuse)
    dets, valid = crowded_clip(2, 48, n_frames=3, n_obj=6)
    ts = dt.init_state(32, 2, device="cpu")
    ts_p = dt.init_state(32, 2, device="cpu")
    assert "fused_steps" in dt.auction_stats
    steps0, calls0 = dt.auction_stats["fused_steps"], dt.auction_stats["calls"]
    for f in range(3):
        ts, out, ov = dt.tracker_step(ts, dets[f], valid[f])
        ts_p, out_p, ov_p = dt.tracker_step_plain(ts_p, dets[f], valid[f])
        assert torch.equal(out, out_p) and torch.equal(ov, ov_p)
    assert dt.auction_stats["fused_steps"] == steps0
    assert dt.auction_stats["calls"] == calls0 + 2 * 3 * 3


def test_the_route_reads_only_the_device_and_the_greedy_switch(monkeypatch):
    monkeypatch.delenv("UNICORN_ASSIGN", raising=False)
    assert dt._fused(torch.device("cuda"))
    assert dt._fused(torch.device("cuda", 1))
    assert not dt._fused(torch.device("cpu"))
    monkeypatch.setenv("UNICORN_ASSIGN", "greedy")
    assert not dt._fused(torch.device("cuda"))
    monkeypatch.setenv("UNICORN_ASSIGN", "auction")
    assert dt._fused(torch.device("cuda"))
