"""The port's mask-stage losses (unicorn_torch/losses/mask.py, boxinst.py,
vos.py) against the JAX package's, on the CPU, from the same numpy inputs.

Where the frameworks part, a case shows that the port's choice is needed:
  * `jax.image.resize` antialiases when it shrinks; F.interpolate without
    antialias misses it by tenths on a 0/1 mask, with it by ulps;
  * `jnp.repeat` puts each sample's copies together; `Tensor.repeat` tiles
    the batch and pairs a slot with another image's features;
  * `jax.lax.top_k` puts the lowest index first among equal scores (every
    background anchor scores 0); the port takes a stable descending sort.

Tolerances, fp32 sums of a few thousand terms in other orders: values rtol
1e-5 (atol 1e-6); gradients within 1e-5 of the largest magnitude of their
tensor; the resize within 1e-6; the slot indices, the SimOTA assignment and
the box bitmasks equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from unicorn_torch.losses import boxinst as tbi
from unicorn_torch.losses import mask as tmask
from unicorn_torch.losses import vos as tvos
from unicorn_torch.models.heads import level_grids as t_level_grids
from unicorn_tpu.losses import boxinst as jbi
from unicorn_tpu.losses import mask as jmask
from unicorn_tpu.losses import vos as jvos
from unicorn_tpu.models.heads import level_grids as j_level_grids

H, W = 64, 96
STRIDES = (8, 16, 32)
HW = [(H // s, W // s) for s in STRIDES]
A = sum(h * w for h, w in HW)
M = 5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _close(got, ref, what="", rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol,
                               atol=atol, err_msg=what)


def _grad_close(got, ref, what):
    ref = np.asarray(ref)
    scale = max(np.abs(ref).max(), 1e-12)
    assert np.abs(np.asarray(got) - ref).max() <= 1e-5 * scale, what


def _slot_inputs(seed, n_fg, up_rate=None, Hm=H // 4, Wm=W // 4, B=2):
    """Head outputs of B images with n_fg foreground anchors each (one of
    them at IoU exactly 0), gt masks (B, M, Hm, Wm); NHWC maps for JAX."""
    rng = np.random.RandomState(seed)
    ctrl = (0.3 * rng.randn(B, A, 169)).astype(np.float32)
    feats = rng.randn(B, H // 8, W // 8, 8).astype(np.float32)
    fg = np.zeros((B, A), bool)
    for b in range(B):
        fg[b, rng.choice(A, n_fg, replace=False)] = True
    piou = (rng.rand(B, A) * fg).astype(np.float32)
    if n_fg:
        piou[np.arange(B), fg.argmax(1)] = 0.0
    mgt = rng.randint(0, M, (B, A)).astype(np.int32)
    gtm = (rng.rand(B, M, Hm, Wm) > 0.6).astype(np.float32)
    up = (None if up_rate is None else
          rng.randn(B, H // 8, W // 8, 9 * up_rate ** 2).astype(np.float32))
    return ctrl, feats, fg, mgt, piou, gtm, up


# -------------------------------------------------------------- resize
@pytest.mark.parametrize("out_hw", [(10, 16), (20, 32), (13, 21), (80, 128)])
def test_resize_antialias_matches_jax_image_resize(out_hw):
    """A 0/1 mask at 40x64 shrunk 4x, 2x and by a ragged factor, and grown
    2x: jax.image.resize's bilinear, which antialiases when it shrinks."""
    rng = np.random.RandomState(0)
    x = (rng.rand(2, 3, 40, 64) > 0.5).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, 3) + out_hw,
                                      "bilinear"))
    got = tmask.resize_antialias(torch.from_numpy(x), *out_hw).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)
    plain = F.interpolate(torch.from_numpy(x), size=out_hw, mode="bilinear",
                          align_corners=False).numpy()
    gap = np.abs(plain - ref).max()
    assert (gap > 0.1) if out_hw[0] < 40 else (gap < 1e-6), gap


# -------------------------------------------------------------- slots
@pytest.mark.parametrize("n_fg", [0, 3, 40])
def test_topk_slots_keep_jax_tie_order(n_fg):
    """Fewer foreground anchors than slots: the rest are background ties
    at 0, lowest index first, as jax.lax.top_k orders them."""
    _, _, fg, _, piou, _, _ = _slot_inputs(1, n_fg)
    valid, topi = tmask.topk_slots(torch.from_numpy(fg),
                                   torch.from_numpy(piou), 16)
    score = jnp.where(jnp.asarray(fg), jnp.asarray(piou) + 1.0, 0.0)
    topv_j, topi_j = jax.lax.top_k(score, 16)
    np.testing.assert_array_equal(topi.numpy(), np.asarray(topi_j))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(topv_j) > 0)
    assert valid.sum(1).tolist() == [min(n_fg, 16)] * 2


def test_fold_slots_is_jnp_repeat_not_tensor_repeat():
    x = np.arange(2 * 3 * 2, dtype=np.float32).reshape(2, 3, 2)
    got = tvos.fold_slots(torch.from_numpy(x), 3).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.repeat(x, 3, axis=0)))
    assert not np.array_equal(torch.from_numpy(x).repeat(3, 1, 1).numpy(), got)


def test_dice_per_instance_matches_jax():
    rng = np.random.RandomState(2)
    s = rng.rand(6, 12, 20).astype(np.float32)
    t = (rng.rand(6, 12, 20) > 0.5).astype(np.float32)
    _close(tmask.dice_per_instance(torch.from_numpy(s), torch.from_numpy(t)),
           jmask.dice_per_instance(jnp.asarray(s), jnp.asarray(t)))


def _condinst_both(inputs, max_inst, up_rate, sample_mask):
    ctrl, feats, fg, mgt, piou, gtm, up = inputs
    sm = None if sample_mask is None else np.asarray(sample_mask, np.float32)

    def j_loss(c, f, u):
        return jmask.condinst_mask_loss(
            c, f, jnp.asarray(fg), jnp.asarray(mgt), jnp.asarray(piou),
            jnp.asarray(gtm), HW, STRIDES, max_inst=max_inst, up_masks=u,
            up_rate=up_rate or 8,
            sample_mask=None if sm is None else jnp.asarray(sm))

    argnums = (0, 1) if up is None else (0, 1, 2)
    lj, gj = jax.value_and_grad(j_loss, argnums)(
        jnp.asarray(ctrl), jnp.asarray(feats),
        None if up is None else jnp.asarray(up))
    tc = torch.from_numpy(ctrl).requires_grad_()
    tf = _nchw(feats).requires_grad_()
    tu = None if up is None else _nchw(up).requires_grad_()
    lt = tmask.condinst_mask_loss(
        tc, tf, torch.from_numpy(fg), torch.from_numpy(mgt).long(),
        torch.from_numpy(piou), torch.from_numpy(gtm), HW, STRIDES,
        max_inst=max_inst, up_masks=tu, up_rate=up_rate or 8,
        sample_mask=None if sm is None else torch.from_numpy(sm))
    lt.backward()
    return (lt, tc, tf, tu), (lj, gj)


@pytest.mark.parametrize("up_rate, Hm, sample_mask", [
    (None, H // 4, None),          # aligned_bilinear to the mask grid
    (None, H // 8, (1.0, 0.0)),    # then shrunk (antialiased) to stride 8
    (4, H // 2, None),             # RAFT x4 to the d_rate-2 grid
    (8, H // 2, (0.0, 1.0)),       # RAFT x8, shrunk to the d_rate-2 grid
])
def test_condinst_mask_loss_matches_jax(up_rate, Hm, sample_mask):
    inputs = _slot_inputs(3, 12, up_rate, Hm, Hm * W // H)
    (lt, tc, tf, tu), (lj, gj) = _condinst_both(inputs, 16, up_rate,
                                                sample_mask)
    _close(lt.item(), float(lj), "loss")
    assert lt.item() > 0
    _grad_close(tc.grad.numpy(), gj[0], "ctrl")
    _grad_close(tf.grad.permute(0, 2, 3, 1).numpy(), gj[1], "mask_feats")
    if tu is not None:
        _grad_close(tu.grad.permute(0, 2, 3, 1).numpy(), gj[2], "up_mask")


def test_invalid_slots_add_exact_zeros():
    """3 foreground anchors, 16 slots: the 13 background slots decode
    finite logits that must reach neither the loss nor its gradient (also
    through a changed target), and an image without foreground adds
    nothing."""
    ctrl, feats, fg, mgt, piou, gtm, up = _slot_inputs(4, 3)
    fg[1] = False
    (lt, tc, _, _), (lj, _) = _condinst_both(
        (ctrl, feats, fg, mgt, piou, gtm, up), 16, None, None)
    _close(lt.item(), float(lj))
    assert torch.isfinite(tc.grad).all()
    used = np.zeros((2, A), bool)
    used[fg] = True
    assert (tc.grad.numpy()[~used] == 0).all()
    assert (tc.grad.numpy()[0][fg[0]] != 0).any()
    # flip the targets that only background slots point at
    gtm2 = gtm.copy()
    unused = sorted(set(range(M)) - set(mgt[0][fg[0]].tolist()))
    assert unused
    gtm2[0, unused] = 1.0 - gtm2[0, unused]
    gtm2[1] = 1.0 - gtm2[1]
    (lt2, _, _, _), _ = _condinst_both((ctrl, feats, fg, mgt, piou, gtm2, up),
                                       16, None, None)
    assert lt2.item() == lt.item()


def _rect_masks(rng, B, n, Hm, Wm):
    """Rectangles with even edges: a 2x shrink of an edge that starts at an
    odd pixel lands on exactly 0.5."""
    m = np.zeros((B, n, Hm, Wm), np.float32)
    for b in range(B):
        for i in range(n):
            y0 = 2 * rng.randint(0, Hm // 2 - 2)
            x0 = 2 * rng.randint(0, Wm // 2 - 2)
            m[b, i, y0:y0 + 2 * rng.randint(1, Hm // 4),
              x0:x0 + 2 * rng.randint(1, Wm // 4)] = 1.0
    return m


@pytest.mark.parametrize("shrink", [1, 2])
def test_semantic_focal_loss_matches_jax(shrink):
    """Masks at the logits' grid (random pixels) and at twice it
    (rectangles), as the inst stage's d_rate-4 masks are. The shrunk mask
    is thresholded at 0.5, and a value at exactly 0.5 in one framework may
    be one ulp above it in the other (ROADMAP Queue 3); the rectangles
    here have even edges, which puts no value within 1e-6 of 0.5, as the
    test checks."""
    rng = np.random.RandomState(5)
    B, Cs, h, w = 2, 6, H // 8, W // 8
    logits = rng.randn(B, h, w, Cs).astype(np.float32)
    if shrink == 1:
        gtm = (rng.rand(B, M, h, w) > 0.5).astype(np.float32)
    else:
        gtm = _rect_masks(rng, B, M, 2 * h, 2 * w)
        small = np.asarray(jax.image.resize(jnp.asarray(gtm),
                                            (B, M, h, w), "bilinear"))
        assert (np.abs(small - 0.5) > 1e-6).all()
        assert ((small > 0) & (small < 1)).any()
    cls = np.array([[0, 2, 5, 7, 1], [3, 3, 0, 0, 4]], np.int32)  # 7: no class
    valid = np.array([[1, 1, 1, 1, 0], [1, 1, 0, 0, 0]], np.float32)
    lj, gj = jax.value_and_grad(lambda x: jmask.semantic_focal_loss(
        x, jnp.asarray(gtm), jnp.asarray(cls), jnp.asarray(valid), Cs))(
        jnp.asarray(logits))
    x = _nchw(logits).requires_grad_()
    lt = tmask.semantic_focal_loss(x, torch.from_numpy(gtm),
                                   torch.from_numpy(cls),
                                   torch.from_numpy(valid), Cs)
    lt.backward()
    _close(lt.item(), float(lj))
    _grad_close(x.grad.permute(0, 2, 3, 1).numpy(), gj, "sem logits")


# -------------------------------------------------------------- VOS pieces
def test_single_image_yolox_loss_matches_jax_vmap():
    """Each slot's YOLOX loss over its one label, normalised by its own
    num_fg: a slot without a box, a small box and a large one."""
    rng = np.random.RandomState(6)
    N = 4
    labels = np.zeros((N, 1, 5), np.float32)
    labels[1, 0, 1:] = [20, 30, 8, 10]
    labels[2, 0, 1:] = [50, 30, 40, 36]
    labels[3, 0, 1:] = [70, 20, 24, 30]
    xs, ys, ss = (np.asarray(a) for a in j_level_grids(HW, STRIDES))
    reg = (0.5 * rng.randn(N, A, 4)).astype(np.float32)
    boxes = np.stack([(reg[..., 0] + xs) * ss, (reg[..., 1] + ys) * ss,
                      np.exp(reg[..., 2]) * ss, np.exp(reg[..., 3]) * ss], -1)
    obj = rng.randn(N, A, 1).astype(np.float32)
    cls = rng.randn(N, A, 1).astype(np.float32)
    for use_l1 in (False, True):
        tot_j, asg_j = jax.vmap(
            lambda l, b, o, c, r: jvos.single_image_yolox_loss(
                l, b, o, c, r, jnp.asarray(xs), jnp.asarray(ys),
                jnp.asarray(ss), (H, W), use_l1))(
            *map(jnp.asarray, (labels, boxes, obj, cls, reg)))
        txs, tys, tss = t_level_grids(HW, STRIDES)
        tot_t, asg_t = tvos.single_image_yolox_loss(
            *map(torch.from_numpy, (labels, boxes.astype(np.float32), obj,
                                    cls, reg)),
            txs, tys, tss, (H, W), use_l1)
        np.testing.assert_array_equal(asg_t.fg_mask.numpy(),
                                      np.asarray(asg_j.fg_mask))
        _close(tot_t.numpy(), tot_j, f"use_l1={use_l1}")
        assert asg_t.fg_mask[0].sum() == 0 and asg_t.fg_mask[1:].any(1).all()


# -------------------------------------------------------------- BoxInst
def test_boxinst_pieces_match_jax():
    rng = np.random.RandomState(7)
    x = rng.randn(3, 12, 20).astype(np.float32)
    for k, d in ((3, 2), (3, 1), (5, 1)):
        _close(tbi.unfold_wo_center(torch.from_numpy(x), k, d),
               jbi.unfold_wo_center(jnp.asarray(x), k, d), f"unfold {k} {d}")
        _close(tbi.compute_pairwise_term(torch.from_numpy(x), k, d),
               jbi.compute_pairwise_term(jnp.asarray(x), k, d),
               f"pairwise {k} {d}")
    s = rng.rand(3, 12, 20).astype(np.float32)
    t = (rng.rand(3, 12, 20) > 0.7).astype(np.float32)
    _close(tbi.compute_project_term(torch.from_numpy(s), torch.from_numpy(t)),
           jbi.compute_project_term(jnp.asarray(s), jnp.asarray(t)))
    rgb = (rng.rand(12, 20, 3) * 255).astype(np.float32)
    rgb[0, :4] = [[0, 0, 0], [1, 2, 3], [255, 255, 255], [10, 0, 250]]
    lab_j = jbi.rgb_to_lab(jnp.asarray(rgb))
    lab_t = tbi.rgb_to_lab(torch.from_numpy(rgb))
    _close(lab_t, lab_j, "lab", atol=1e-4)
    _close(tbi.images_color_similarity(lab_t.permute(2, 0, 1)[None])[0],
           jbi.images_color_similarity(lab_j), "similarity", atol=1e-5)
    boxes = np.array([[20, 16, 30, 12], [5, 5, 4, 4], [60, 40, 200, 90],
                      [0, 0, 0, 0]], np.float32)
    valid = np.array([1, 1, 1, 0], np.float32)
    np.testing.assert_array_equal(
        tbi.boxes_to_bitmasks(torch.from_numpy(boxes),
                              torch.from_numpy(valid), 16, 24, 4.0).numpy(),
        np.asarray(jbi.boxes_to_bitmasks(jnp.asarray(boxes),
                                         jnp.asarray(valid), 16, 24, 4.0)))


@pytest.mark.parametrize("up_rate", [None, 8])
def test_boxinst_mask_loss_matches_jax(up_rate):
    """Both terms and their gradients, with the warm-up factor a value of
    its own; d_rate 4 without RAFT, d_rate 2 with RAFT x8 (shrunk)."""
    d_rate = 4 if up_rate is None else 2
    ctrl, feats, fg, mgt, piou, _, up = _slot_inputs(8, 10, up_rate)
    rng = np.random.RandomState(9)
    images = (rng.rand(2, H, W, 3) * 255).astype(np.float32)
    boxes = np.zeros((2, M, 4), np.float32)
    boxes[:, :4] = np.stack([rng.uniform(16, 80, (2, 4)),
                             rng.uniform(16, 48, (2, 4)),
                             rng.uniform(8, 40, (2, 4)),
                             rng.uniform(8, 32, (2, 4))], -1)
    valid = (boxes.sum(2) > 0).astype(np.float32)

    def j_loss(c, f, u):
        prj, pw = jbi.boxinst_mask_loss(
            c, f, jnp.asarray(fg), jnp.asarray(mgt), jnp.asarray(piou),
            jnp.asarray(boxes), jnp.asarray(valid), jnp.asarray(images), HW,
            STRIDES, max_inst=16, up_masks=u, up_rate=up_rate or 8,
            d_rate=d_rate, warmup_factor=0.25)
        return prj + 3.0 * pw, (prj, pw)

    argnums = (0, 1) if up is None else (0, 1, 2)
    (_, (prj_j, pw_j)), gj = jax.value_and_grad(j_loss, argnums,
                                                has_aux=True)(
        jnp.asarray(ctrl), jnp.asarray(feats),
        None if up is None else jnp.asarray(up))
    tc = torch.from_numpy(ctrl).requires_grad_()
    tf = _nchw(feats).requires_grad_()
    tu = None if up is None else _nchw(up).requires_grad_()
    prj_t, pw_t = tbi.boxinst_mask_loss(
        tc, tf, torch.from_numpy(fg), torch.from_numpy(mgt).long(),
        torch.from_numpy(piou), torch.from_numpy(boxes),
        torch.from_numpy(valid), _nchw(images), HW, STRIDES, max_inst=16,
        up_masks=tu, up_rate=up_rate or 8, d_rate=d_rate, warmup_factor=0.25)
    (prj_t + 3.0 * pw_t).backward()
    _close(prj_t.item(), float(prj_j), "projection")
    _close(pw_t.item(), float(pw_j), "pairwise")
    assert prj_t.item() > 0 and pw_t.item() > 0
    _grad_close(tc.grad.numpy(), gj[0], "ctrl")
    _grad_close(tf.grad.permute(0, 2, 3, 1).numpy(), gj[1], "mask_feats")
    if tu is not None:
        _grad_close(tu.grad.permute(0, 2, 3, 1).numpy(), gj[2], "up_mask")
