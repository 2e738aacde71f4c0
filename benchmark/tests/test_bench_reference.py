"""The plain reference against the port's plain CPU path at a small size, in
fp32: the model, the letterbox, the decode and NMS, the tracker, the uni
loss with its gradients, and the update."""
from __future__ import annotations

import pytest
import torch

from benchmark import harness, weights
from benchmark.reference import model as ref_model
from benchmark.reference import postprocess as ref_post
from benchmark.reference import tracker as ref_tracker
from benchmark.reference import train as ref_train

SEED = 2 ** 31 + 11
HW = (64, 96)


def _cfg(bf16=False):
    cfg = harness.load_json(harness.BENCH + "/configs/unicorn_track_tiny.json")
    cfg["exp_fields"].update(input_size=list(HW), test_size=list(HW),
                             bf16=bf16, serve_interact_bf16=bf16)
    return cfg


def _program_model(cfg, serve):
    exp = harness.program_exp(cfg)
    m = harness.program_model(exp, "cpu", serve)
    weights.load_seeded(m, SEED, cfg["prior_raise"])
    return exp, m


def _reference(cfg):
    m = ref_model.build(cfg["exp_fields"], "cpu", remat=False)
    return weights.load_seeded(m, SEED, cfg["prior_raise"])


@pytest.fixture(scope="module")
def models():
    torch.manual_seed(0)
    cfg = _cfg()
    exp, prog = _program_model(cfg, serve=True)
    return cfg, exp, prog.eval(), _reference(cfg).eval()


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def test_same_parameters(models):
    _, _, prog, ref = models
    p, r = dict(prog.named_parameters()), dict(ref.named_parameters())
    assert p.keys() == r.keys()
    assert all(torch.equal(p[k], r[k]) for k in p)


def test_forward_whole(models):
    _, _, prog, ref = models
    x = torch.rand(2, 3, *HW) * 255
    with torch.no_grad():
        raw, _ = prog.forward_whole(x)
        ref_out = ref.forward_whole(x)
    for p_lv, r_lv in zip(raw, ref_out):
        for k in ("reg", "obj", "cls", "reg_sot", "obj_sot", "cls_sot"):
            assert _rel(p_lv[k], r_lv[k]) < 1e-4, k


def test_letterbox():
    from unicorn_torch.ops.letterbox import letterbox_batch_device

    g = torch.Generator().manual_seed(3)
    frames = torch.randint(0, 256, (2, 90, 160, 3), generator=g,
                           dtype=torch.uint8)
    a = letterbox_batch_device(frames, HW)
    b = ref_post.letterbox(frames, HW)
    d = (a - b).abs()
    assert float(d.max()) <= 1.0 and float((d > 0.5).float().mean()) < 0.02


def test_decode_and_nms(models):
    from unicorn_torch.models.heads import decode_for_inference
    from unicorn_torch.ops.nms import postprocess_device

    cfg, exp, prog, _ = models
    with torch.no_grad():
        raw, _ = prog.forward_whole(torch.rand(2, 3, *HW) * 255)
    dec = decode_for_inference(raw, (8, 16, 32), mode="mot")
    dets, valid = postprocess_device(
        dec, num_classes=8, conf_thre=0.01, nms_thre=0.65,
        class_agnostic=False, n_cand=64, max_out=32, cluster_iters=8)
    dets5 = torch.cat([dets[..., :4], (dets[..., 4] * dets[..., 5])[..., None]],
                      -1)
    d_ref, v_ref = ref_post.nms(ref_post.decode(raw), 8, 0.01, 0.65, 64, 32,
                                cluster_iters=8)
    # the same operations on the same inputs; the CPU's exp and sigmoid may
    # round by another path on another memory layout
    assert int(valid.sum()) > 0
    assert torch.equal(valid, v_ref)
    torch.testing.assert_close(dets5 * valid[..., None],
                               d_ref * v_ref[..., None], rtol=1e-6, atol=1e-5)


def test_tracker():
    from unicorn_torch.tracker.device_tracker import init_state, tracker_step

    g = torch.Generator().manual_seed(5)
    S, D = 2, 12
    base = torch.rand(S, D, 2, generator=g) * 400
    wh = 20 + torch.rand(S, D, 2, generator=g) * 60
    ts_p, ts_r = init_state(16, S, "cpu"), ref_tracker.init_state(16, S, "cpu")
    n_rows = 0
    for t in range(12):
        c = base + t * 3 + torch.randn(S, D, 2, generator=g)
        dets = torch.cat([c - wh / 2, c + wh / 2,
                          torch.rand(S, D, 1, generator=g)], -1)
        valid = torch.rand(S, D, generator=g) > 0.2
        ts_p, out_p, ov_p = tracker_step(ts_p, dets, valid)
        ts_r, out_r, ov_r = ref_tracker.tracker_step(ts_r, dets, valid)
        assert torch.equal(ov_p, ov_r)
        assert torch.equal(out_p[ov_p], out_r[ov_r])
        n_rows += int(ov_p.sum())
    assert n_rows > 0


def test_uni_loss_and_update():
    """The port's uni loss, its gradients and two micro-steps of its update
    and EMA against the reference's, fp32, at a small size."""
    from unicorn_torch.core.train_state import TrainState, rewind_opt_counts
    from unicorn_torch.core.train_step import uni_loss_fn

    from benchmark.kinds import uni_step

    cfg = _cfg()
    cfg["exp_fields"]["remat"] = False
    cell = type("C", (), {})()
    cell.cfg = cfg
    cell.traffic = dict(harness.load_json(
        harness.BENCH + "/traffic/uni_step.json"), ring=2,
        objects={"1": 1, "2": 3}, object_px=[8, 24])
    batches = uni_step.make_batches(cell, SEED, torch.device("cpu"))
    exp, prog = _program_model(cfg, serve=False)
    prog.train()
    ref = _reference(cfg).train()
    e = cfg["exp_fields"]
    state = TrainState.create(prog, exp.get_optimizer(16, 12500),
                              use_ema=True, device="cpu")
    rewind_opt_counts(state, 6250, 12500)
    named = list(ref.named_parameters())
    p0 = [p.detach().clone() for _, p in named]
    opt = ref_train.AdamWAccum(
        named, lambda it: state.tx.lr_fn(it), e["weight_decay"], 2, 12500)
    ema = ref_train.EMA([p for _, p in named], 12500)
    for images, targets, task_ids in batches:
        total_p, _ = uni_loss_fn(prog, images, targets, task_ids, HW,
                                 mot_weight=3.0, bidirect=True, use_l1=True,
                                 num_classes=8, mhs=True)
        total_r, _ = ref_train.uni_loss(ref, images, targets, task_ids, HW,
                                        3.0)
        lp, lr_ = float(total_p.detach()), float(total_r.detach())
        assert abs(lp - lr_) <= 1e-4 * abs(lr_)
        total_p.backward()
        total_r.backward()
        gp = dict(prog.named_parameters())
        for n, p in named:
            if p.grad is not None and p.grad.norm() > 0:
                assert _rel(gp[n].grad, p.grad) < 1e-3, n
        state.apply_gradients()
        opt.step()
        ema.update()
    # Adam's first step is g / (|g| + eps) elementwise: where |g| is near
    # eps the two fp32 gradients' rounding shows (gradients agree to 1e-3),
    # so each tensor's change is held to 5% of its norm
    gp = dict(prog.named_parameters())
    moved = 0
    for (n, p), q in zip(named, p0):
        if not torch.equal(p, q):
            moved += 1
            assert _rel(gp[n].detach() - q, p.detach() - q) < 5e-2, n
    assert moved > len(named) // 2
    # the EMA copy moved on both micro-steps, by the same rule
    ge = dict(state.ema_model.named_parameters())
    for (n, p), e_ref, q in zip(named, ema.ema, p0):
        if not torch.equal(p, q):
            assert _rel(ge[n].detach() - q, e_ref - q) < 5e-2, n
