"""The port's training losses and schedules (unicorn_torch/losses,
core/schedule.py, ops/correlation.py dice_loss) against the JAX package's,
on the CPU, from the same numpy inputs.

Tolerances. The SimOTA assignment (`fg_mask`, `matched_gt`) must be EQUAL;
losses rtol 1e-5 (fp32 sums of a few hundred terms in other orders);
schedules rtol 1e-6 (the JAX package computes them in fp32, the port in
Python floats). The assignment sorts costs that differ between anchors by
far more than the ulp-level differences of log and sigmoid between the two
frameworks, except among anchors excluded with the same constant, where the
port's stable sort reproduces `jax.lax.top_k`'s lowest-index-first order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unicorn_torch.core import schedule as ts
from unicorn_torch.losses import det as tdet
from unicorn_torch.losses import uni as tuni
from unicorn_torch.losses.vos import match_instance_pairs as t_match
from unicorn_torch.models.heads import level_grids as t_level_grids
from unicorn_torch.ops.correlation import dice_loss as t_dice
from unicorn_tpu.core import schedule as js
from unicorn_tpu.losses import det as jdet
from unicorn_tpu.losses import uni as juni
from unicorn_tpu.losses.vos import match_instance_pairs as j_match
from unicorn_tpu.models.heads import level_grids as j_level_grids
from unicorn_tpu.ops.correlation import dice_loss as j_dice

H, W = 96, 160
STRIDES = (8, 16, 32)
HW = [(H // s, W // s) for s in STRIDES]
A = sum(h * w for h, w in HW)
C = 8
M = 6


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _labels():
    """(3, M, 5) [cls, cx, cy, w, h]: image 0 with four gts, one of them a
    2x2 px box in the corner that no anchor centre falls into (fewer than 10
    in-box-and-centre candidates: its 10 cheapest are ties at the 1e5
    level), and one of class 9, outside [0, C); image 1 without a gt; image
    2 with two overlapping gts."""
    lab = np.zeros((3, M, 5), np.float32)
    lab[0, :4] = [[2, 50, 40, 40, 30], [5, 110, 60, 60, 50],
                  [1, 1.5, 1.5, 2, 2], [9, 30, 80, 20, 16]]
    lab[2, :2] = [[0, 80, 48, 70, 60], [3, 90, 52, 64, 56]]
    return lab


def _predictions(seed):
    rng = np.random.RandomState(seed)
    reg_raw = (0.5 * rng.randn(3, A, 4)).astype(np.float32)
    obj = rng.randn(3, A, 1).astype(np.float32)
    cls = rng.randn(3, A, C).astype(np.float32)
    return reg_raw, obj, cls


def _grids():
    xs, ys, ss = j_level_grids(HW, STRIDES)
    txs, tys, tss = t_level_grids(HW, STRIDES)
    np.testing.assert_array_equal(np.asarray(xs), txs.numpy())
    np.testing.assert_array_equal(np.asarray(ss), tss.numpy())
    return (xs, ys, ss), (txs, tys, tss)


def _decode(reg_raw, grids):
    xs, ys, ss = (np.asarray(g) for g in grids)
    return np.stack([(reg_raw[..., 0] + xs) * ss, (reg_raw[..., 1] + ys) * ss,
                     np.exp(reg_raw[..., 2]) * ss,
                     np.exp(reg_raw[..., 3]) * ss], -1).astype(np.float32)


def test_iou_functions_match_jax():
    rng = np.random.RandomState(0)
    gt = rng.uniform(5, 60, (2, 5, 4)).astype(np.float32)
    pred = rng.uniform(5, 60, (2, 40, 4)).astype(np.float32)
    out = tdet.iou_pairwise_cxcywh(*_t(gt, pred)).numpy()
    ref = jax.vmap(jdet.iou_pairwise_cxcywh)(jnp.asarray(gt), jnp.asarray(pred))
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-6, atol=1e-7)
    tgt = rng.uniform(5, 60, (2, 40, 4)).astype(np.float32)
    out = tdet.iou_elementwise_cxcywh(*_t(pred, tgt)).numpy()
    ref = jax.vmap(jdet.iou_elementwise_cxcywh)(jnp.asarray(pred),
                                                jnp.asarray(tgt))
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-6, atol=1e-7)


def test_geometry_constraints_equal_jax():
    jg, tg = _grids()
    lab = _labels()
    valid = lab.sum(2) > 0
    out = tdet.get_geometry_constraints(*_t(lab[..., 1:5], valid), *tg, (H, W))
    ref = jax.vmap(lambda b, v: jdet.get_geometry_constraints(
        b, v, *jg, (H, W)))(jnp.asarray(lab[..., 1:5]), jnp.asarray(valid))
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the corner gt has centre candidates but no anchor centre inside it
    assert not out[0][0, 2].any() and out[1][0, 2].any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_simota_assign_equals_jax(seed):
    jg, tg = _grids()
    lab = _labels()
    reg_raw, obj, cls = _predictions(seed)
    boxes = _decode(reg_raw, jg)
    valid = lab.sum(2) > 0
    gcls = lab[..., 0].astype(np.int32)
    out = tdet.simota_assign(*_t(lab[..., 1:5], gcls, valid, boxes, obj, cls),
                             *tg, (H, W))
    ref = jax.vmap(lambda gb, gc, gv, pb, ol, cl: jdet.simota_assign(
        gb, gc, gv, pb, ol, cl, *jg, (H, W)))(
        *(jnp.asarray(a) for a in (lab[..., 1:5], gcls, valid, boxes, obj,
                                   cls)))
    np.testing.assert_array_equal(out.fg_mask.numpy(), np.asarray(ref.fg_mask))
    np.testing.assert_array_equal(out.matched_gt.numpy(),
                                  np.asarray(ref.matched_gt))
    np.testing.assert_allclose(out.pred_iou.numpy(), np.asarray(ref.pred_iou),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(out.num_fg.numpy(), np.asarray(ref.num_fg))
    np.testing.assert_array_equal(out.num_gt.numpy(), [4, 0, 2])
    assert out.num_fg[1] == 0 and out.num_fg[0] >= 4
    # the corner gt got its anchor out of the tied candidates
    assert (out.matched_gt[0][out.fg_mask[0]] == 2).any()
    assert not out.pred_iou.requires_grad


def test_stable_sort_is_what_keeps_the_tie_order():
    """Among equal costs jax.lax.top_k returns the lowest index first; the
    port's stable sort does too, where torch.topk promises nothing."""
    cost = np.full((1, 1, 64), 1e9, np.float32)
    cost[0, 0, [40, 7, 23]] = [1.0, 1.0, 2.0]
    _, idx_j = jax.lax.top_k(-jnp.asarray(cost), 10)
    idx_t = torch.from_numpy(cost).sort(dim=2, stable=True).indices[..., :10]
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    assert idx_t[0, 0, :5].tolist() == [7, 40, 23, 0, 1]


@pytest.mark.parametrize("use_l1", [False, True])
@pytest.mark.parametrize("mask", [None, (1.0, 1.0, 0.0), (0.0, 1.0, 0.0)])
def test_yolox_losses_match_jax(use_l1, mask):
    """Also with a sample_mask, and with one that keeps only the image
    without a gt (num_fg is clamped to 1)."""
    jg, tg = _grids()
    lab = _labels()
    reg_raw, obj, cls = _predictions(3)
    boxes = _decode(reg_raw, jg)
    tm = None if mask is None else torch.tensor(mask)
    jm = None if mask is None else jnp.asarray(mask)
    out, assign = tdet.yolox_losses(*_t(lab, boxes, obj, cls, reg_raw), *tg,
                                    (H, W), use_l1=use_l1, sample_mask=tm)
    ref, assign_j = jdet.yolox_losses(
        *(jnp.asarray(a) for a in (lab, boxes, obj, cls, reg_raw)), *jg,
        (H, W), use_l1=use_l1, sample_mask=jm)
    np.testing.assert_array_equal(assign.fg_mask.numpy(),
                                  np.asarray(assign_j.fg_mask))
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
        assert np.isfinite(out[k].numpy())


def _targets(seed=0, Mt=5):
    """(3, 2, Mt, 6): sample 0 with three tracks of which two match, sample 1
    with none matching, sample 2 with ids in another order and a zero id."""
    rng = np.random.RandomState(seed)
    t = np.zeros((3, 2, Mt, 6), np.float32)
    t[..., :4, 0] = rng.randint(0, C, (3, 2, 4))
    t[..., :4, 1] = rng.uniform(20, W - 20, (3, 2, 4))
    t[..., :4, 2] = rng.uniform(15, H - 15, (3, 2, 4))
    t[..., :4, 3:5] = rng.uniform(12, 50, (3, 2, 4, 2))
    t[0, 0, :4, 5] = [4, 7, 9, 0]
    t[0, 1, :4, 5] = [9, 3, 4, 0]
    t[1, 0, :4, 5] = [1, 2, 0, 0]
    t[1, 1, :4, 5] = [5, 6, 0, 0]
    t[2, 0, :4, 5] = [0, 8, 2, 5]
    t[2, 1, :4, 5] = [5, 2, 8, 11]
    t[..., 4, :] = 0
    return t


@pytest.mark.parametrize("max_pairs", [1, 3])
def test_match_instance_pairs_equals_jax(max_pairs):
    t = _targets()
    out = t_match(torch.from_numpy(t), max_pairs)
    ref = j_match(jnp.asarray(t), max_pairs)
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    v = np.asarray(ref[2])
    for a, b in zip(out[:2], ref[:2]):          # slots without a pair: any
        np.testing.assert_array_equal(a.numpy()[v], np.asarray(b)[v])
    assert v[:, 0].tolist() == [True, False, True]


def test_build_mhs_labels_equals_jax():
    t = _targets()
    out, has = tuni.build_mhs_labels(torch.from_numpy(t))
    ref, has_j = juni.build_mhs_labels(jnp.asarray(t))
    np.testing.assert_array_equal(has.numpy(), np.asarray(has_j))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert out[0, 0, 0, 5] == 4 and out[0, 1, 0, 5] == 4 and not out[1].any()


@pytest.mark.parametrize("bidirect", [True, False])
def test_mot_contrastive_loss_matches_jax(bidirect):
    t = _targets(1)
    rng = np.random.RandomState(2)
    e0 = rng.randn(3, 12, 20, 16).astype(np.float32)
    e1 = rng.randn(3, 12, 20, 16).astype(np.float32)
    out = tuni.mot_contrastive_loss_single(
        torch.from_numpy(e0).permute(0, 3, 1, 2),
        torch.from_numpy(e1).permute(0, 3, 1, 2), torch.from_numpy(t),
        bidirect)
    ref = jax.vmap(lambda a, b, c: juni.mot_contrastive_loss_single(
        a, b, c, bidirect))(jnp.asarray(e0), jnp.asarray(e1), jnp.asarray(t))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    assert out[1] == 0                      # no matched pair: no valid row


def test_sample_instance_embeddings_matches_jax():
    rng = np.random.RandomState(3)
    e = rng.randn(2, 12, 20, 8).astype(np.float32)
    pts = rng.uniform(-10, 170, (2, 9, 2)).astype(np.float32)
    out = tuni.sample_instance_embeddings(
        torch.from_numpy(e).permute(0, 3, 1, 2), torch.from_numpy(pts))
    ref = jax.vmap(juni.sample_instance_embeddings)(jnp.asarray(e),
                                                    jnp.asarray(pts))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("mask", [None, (1.0, 0.0, 1.0)])
def test_dice_loss_matches_jax(mask):
    rng = np.random.RandomState(4)
    p = rng.rand(3, 12, 20).astype(np.float32)
    g = (rng.rand(3, 12, 20) > 0.7).astype(np.float32)
    out = t_dice(*_t(p, g), None if mask is None else torch.tensor(mask))
    ref = j_dice(jnp.asarray(p), jnp.asarray(g),
                 None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6)


def test_build_sot_priors_matches_jax():
    """fp32 correlation on both sides (the JAX dispatch takes its streaming
    XLA form off the TPU): atol 1e-5 on priors in [0, 1]."""
    t = _targets(5)
    rng = np.random.RandomState(5)
    e0 = rng.randn(3, 12, 20, 16).astype(np.float32)
    e1 = rng.randn(3, 12, 20, 16).astype(np.float32)
    task = np.array([1, 2, 1], np.int32)
    pred, gt1 = tuni.build_sot_priors(
        torch.from_numpy(e0).permute(0, 3, 1, 2),
        torch.from_numpy(e1).permute(0, 3, 1, 2), torch.from_numpy(t), (H, W),
        torch.from_numpy(task))
    pred_j, gt1_j = juni.build_sot_priors(
        jnp.asarray(e0), jnp.asarray(e1), jnp.asarray(t), (H, W),
        jnp.asarray(task))
    assert tuple(pred.shape) == (3, 1, 12, 20)
    np.testing.assert_allclose(pred.permute(0, 2, 3, 1).numpy(),
                               np.asarray(pred_j), atol=1e-5)
    np.testing.assert_allclose(gt1.permute(0, 2, 3, 1).numpy(),
                               np.asarray(gt1_j), atol=1e-6)
    assert not pred[1].any() and pred[0].max() > 0


def _head_raw(seed):
    """Per-level packed head outputs as both frameworks lay them out."""
    rng = np.random.RandomState(seed)
    j_out, t_out = [], []
    for h, w in HW:
        cp = rng.randn(3, h, w, C + 1).astype(np.float32)
        rp = (0.5 * rng.randn(3, h, w, 10)).astype(np.float32)
        keys = {"cls": cp[..., :C], "cls_sot": cp[..., C:],
                "reg_sot": rp[..., 5:9], "obj_sot": rp[..., 9:]}
        j_out.append({"_cls_packed": jnp.asarray(cp),
                      "_reg_packed": jnp.asarray(rp),
                      **{k: jnp.asarray(v) for k, v in keys.items()}})
        t_out.append({"_cls_packed": torch.from_numpy(cp).permute(0, 3, 1, 2),
                      "_reg_packed": torch.from_numpy(rp).permute(0, 3, 1, 2),
                      **{k: torch.from_numpy(v).permute(0, 3, 1, 2)
                         for k, v in keys.items()}})
    return j_out, t_out


@pytest.mark.parametrize("sot_only", [False, True])
@pytest.mark.parametrize("tasks", [(1, 2, 1), (2, 2, 2), (1, 1, 1)])
def test_unicorn_uni_loss_matches_jax(sot_only, tasks):
    t = _targets(6)
    rng = np.random.RandomState(6)
    e0 = rng.randn(3, 12, 20, 16).astype(np.float32)
    e1 = rng.randn(3, 12, 20, 16).astype(np.float32)
    prior = rng.rand(3, 12, 20, 1).astype(np.float32)
    gt1 = (rng.rand(3, 12, 20, 1) > 0.8).astype(np.float32)
    j_raw, t_raw = _head_raw(7)
    task = np.array(tasks, np.int32)
    kw = dict(num_classes=C, mot_weight=3.0, use_l1=True, sot_only=sot_only)

    def nchw(a):
        return torch.from_numpy(a).permute(0, 3, 1, 2)

    out = tuni.unicorn_uni_loss(t_raw, nchw(e0), nchw(e1), nchw(prior),
                                nchw(gt1), torch.from_numpy(t),
                                torch.from_numpy(task), (H, W), **kw)
    ref = juni.unicorn_uni_loss(j_raw, *(jnp.asarray(a) for a in
                                         (e0, e1, prior, gt1, t, task)),
                                (H, W), **kw)
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


ITERS = [0, 1, 7, 50, 99, 100, 101, 400, 750, 1199, 1200, 1499, 1600]


def test_schedules_match_jax():
    """A dozen iterations across warm-up, cosine and the floor; the JAX
    package computes in fp32: rtol 1e-5, atol 1e-9."""
    for it in ITERS:
        np.testing.assert_allclose(
            ts.yolox_warm_cos_lr(0.01, 0.05, 1500, 100, 0.0, 300, it),
            float(js.yolox_warm_cos_lr(0.01, 0.05, 1500, 100, 0.0, 300, it)),
            rtol=1e-5, atol=1e-9, err_msg=f"yolox {it}")
        np.testing.assert_allclose(
            ts.warm_cos_lr(0.01, 1500, 100, 1e-4, it),
            float(js.warm_cos_lr(0.01, 1500, 100, 1e-4, it)),
            rtol=1e-5, atol=1e-9, err_msg=f"warmcos {it}")
        np.testing.assert_allclose(
            ts.multistep_lr(0.01, (100, 750), 0.1, it),
            float(js.multistep_lr(0.01, (100, 750), 0.1, it)), rtol=1e-5,
            err_msg=f"multistep {it}")


def test_ema_decay_schedule_matches_jax():
    """atol 1e-7: the JAX package takes 1 - exp(-t / 2000) in fp32, which
    cancels to about 6e-8 at small t; the port takes it in a Python float."""
    for it in ITERS + [20000]:
        np.testing.assert_allclose(
            ts.ema_decay_schedule(0.9998, it),
            float(js.ema_decay_schedule(0.9998, it)), rtol=1e-5, atol=1e-7)
    assert ts.ema_decay_schedule(0.9998, 0) == 0.0
