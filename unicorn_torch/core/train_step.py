"""Train-step factories for the det, uni, inst (det + mask) and VOS + MOTS
(uni + mask) stages (port of unicorn_tpu/core/train_step.py).

The uni step stacks the two frames into one 2B batch through the backbone,
runs the interaction and the embedding upsample in fp32, builds the SOT
priors by correlation propagation, calls the unified head once and sums the
masked task losses. On the card every kernel of the model and the three
correlation training kernels run in the forward and in the backward.

The mask steps add the CondInst dice loss over SimOTA's foreground anchors
(or BoxInst's box-supervised terms) to the detection loss; the VOS + MOTS
step adds the VOS slots (losses/vos.py) beside the MOTS head loss. Their
experiments train only the controllers and the mask branch: the backward
then reaches neither the frozen trunk nor, in the VOS + MOTS step, the
correlation's backward kernels.

Layout: images (B, 2, 3, H, W), as the port's models take NCHW (the JAX
package takes (B, 2, H, W, 3)); targets (B, 2, M, 6), task_ids (B,) and
masks (B, 2, M, Hm, Wm) as there; the inst step's images (B, 3, H, W),
labels (B, M, 5) and masks (B, M, Hm, Wm). A step function takes (state,
*batch), all on the state's device, updates the state in place and returns
(state, loss_dict).
"""
from __future__ import annotations

import torch

from ..losses.boxinst import boxinst_mask_loss
from ..losses.det import yolox_losses
from ..losses.mask import condinst_mask_loss, semantic_focal_loss
from ..losses.uni import (build_mhs_labels, build_sot_priors,
                          mot_contrastive_loss_single, unicorn_uni_loss)
from ..losses.vos import vos_loss
from ..models.heads import decode_boxes, flatten_raw_outputs, level_grids
from ..ops.correlation import resize_bilinear_torch
from ..parallel import mesh as mesh_mod
from ..parallel.mesh import global_sum
from ..utils.profiling import span, spanned


def det_loss_fn(model, images, labels, img_size, use_l1=False,
                strides=(8, 16, 32)):
    """Detection pretraining loss of a YOLOXDet without the mask branch
    (the det stage's model). images (B, 3, H, W); labels (B, M, 5)."""
    head_raw = model(images)
    flat = flatten_raw_outputs(head_raw, "mot")
    boxes = decode_boxes(flat["reg_raw"], flat["hw"], strides)
    xs, ys, ss = level_grids(flat["hw"], strides, images.device)
    loss_dict, _ = yolox_losses(
        labels, boxes, flat["obj_logits"], flat["cls_logits"],
        flat["reg_raw"], xs, ys, ss, img_size, use_l1=use_l1)
    return loss_dict["total_loss"], loss_dict


def uni_forward_embeddings(model, images, backbone_map=False):
    """Backbone + interaction + upsample for a 2-frame batch. images
    (B, 2, 3, H, W). Returns (fpn_outs_1, embed_0, embed_1): both frames
    share one backbone pass as a 2B batch, frame-major, and the stride-16
    features are cast to fp32 for the interaction.

    backbone_map=True runs the backbone once a frame over the 2B frames at
    batch 1 and concatenates the outputs: the same math (the PAFPN's
    GroupNorm is per sample), JAX's lax.map. In eager PyTorch autograd
    keeps every frame's activations until the backward all the same, so
    it lowers the peak only together with remat, whose blocks keep
    little."""
    B, n_frames = images.shape[:2]
    assert n_frames == 2
    imgs_flat = images.transpose(0, 1).reshape(2 * B, *images.shape[2:])
    if backbone_map:
        outs = [model.forward_backbone(imgs_flat[i:i + 1])
                for i in range(2 * B)]
        fpn_outs = tuple(torch.cat([o[0][k] for o in outs])
                         for k in range(len(outs[0][0])))
        feat16 = torch.cat([o[1] for o in outs])
    else:
        fpn_outs, feat16 = model.forward_backbone(imgs_flat)
    fpn_outs_1 = tuple(x[B:] for x in fpn_outs)
    new0, new1 = model.forward_interaction(feat16[:B].float(),
                                           feat16[B:].float())
    return fpn_outs_1, model.forward_upsample(new0), model.forward_upsample(new1)


def uni_loss_fn(model, images, targets, task_ids, img_size, mot_weight=1.0,
                sot_weight=1.0, bidirect=True, use_l1=False, num_classes=8,
                mhs=False, mhs_weight=0.5, backbone_map=False):
    """The unified SOT+MOT loss of a (B, 2, ...) batch -> (total,
    loss_dict)."""
    fpn_outs_1, embed_0, embed_1 = uni_forward_embeddings(
        model, images, backbone_map=backbone_map)
    pred_prior, gt_lbs1 = build_sot_priors(embed_0, embed_1, targets,
                                           img_size, task_ids)
    H8, W8 = pred_prior.shape[2:]

    def prior_pyramid(p):
        return (p, resize_bilinear_torch(p, H8 // 2, W8 // 2),
                resize_bilinear_torch(p, H8 // 4, W8 // 4))

    head_raw = model.forward_head(fpn_outs_1, prior_pyramid(pred_prior))
    loss_dict = unicorn_uni_loss(
        head_raw, embed_0, embed_1, pred_prior, gt_lbs1, targets, task_ids,
        img_size, num_classes=num_classes, mot_weight=mot_weight,
        sot_weight=sot_weight, bidirect=bidirect, use_l1=use_l1)
    total = loss_dict["total_loss"]

    if mhs:
        # MOT-helps-SOT: the SOT branch on MOT samples, with a synthetic
        # single-instance label pair
        mhs_targets, has_pair = build_mhs_labels(targets)
        mhs_task = ((task_ids == 2) & has_pair).to(task_ids.dtype)
        mhs_prior, mhs_gt1 = build_sot_priors(embed_0, embed_1, mhs_targets,
                                              img_size, mhs_task)
        mhs_raw = model.forward_head(fpn_outs_1, prior_pyramid(mhs_prior))
        # mhs_task is in {0, 1}: the MOT branch would weigh zero
        mhs_dict = unicorn_uni_loss(
            mhs_raw, embed_0, embed_1, mhs_prior, mhs_gt1, mhs_targets,
            mhs_task, img_size, num_classes=num_classes, use_l1=use_l1,
            sot_only=True)
        # the reference adds the subset-normalised SOT loss: undo the n / B
        # weighting of unicorn_uni_loss
        B = global_sum(targets.shape[0], like=targets)
        n_mhs = global_sum((mhs_task == 1).float().sum()).clamp_min(1.0)
        mhs_loss = mhs_dict["total_loss"] * B / n_mhs
        total = total + mhs_weight * mhs_loss
        loss_dict["mhs_loss"] = mhs_loss
        loss_dict["total_loss"] = total
    return total, loss_dict


def det_mask_loss_fn(model, images, labels, masks, img_size,
                     use_l1=False, strides=(8, 16, 32), max_inst=24,
                     sem_loss_on=False, boxinst=False, warmup_factor=1.0,
                     d_rate=4):
    """The inst stage's loss: the detection losses plus the CondInst dice
    over the SimOTA-matched anchors. images (B, 3, H, W); labels (B, M, 5);
    masks (B, M, Hm, Wm) at the d_rate grid.

    boxinst=True supervises the masks with the boxes alone (BoxInst's
    projection and pairwise terms; `masks` is then unused) and
    `warmup_factor` scales the pairwise term. sem_loss_on adds the semantic
    head's focal loss where the model has that head."""
    head_raw, (mask_feats, up_mask, sem_logits) = model(images)
    flat = flatten_raw_outputs(head_raw, "mot")
    boxes = decode_boxes(flat["reg_raw"], flat["hw"], strides)
    xs, ys, ss = level_grids(flat["hw"], strides, images.device)
    loss_dict, assign = yolox_losses(
        labels, boxes, flat["obj_logits"], flat["cls_logits"],
        flat["reg_raw"], xs, ys, ss, img_size, use_l1=use_l1)
    if boxinst:
        gt_valid = (labels[..., 1:5].sum(2) > 0).float()
        prj_l, pw_l = boxinst_mask_loss(
            flat["ctrl"], mask_feats, assign.fg_mask, assign.matched_gt,
            assign.pred_iou, labels[..., 1:5], gt_valid, images, flat["hw"],
            strides, max_inst=max_inst, up_masks=up_mask,
            warmup_factor=warmup_factor, d_rate=d_rate)
        mask_l = prj_l + pw_l
        loss_dict["boxinst_prj_loss"] = prj_l
        loss_dict["boxinst_pairwise_loss"] = pw_l
    else:
        mask_l = condinst_mask_loss(
            flat["ctrl"], mask_feats, assign.fg_mask, assign.matched_gt,
            assign.pred_iou, masks, flat["hw"], strides, max_inst=max_inst,
            up_masks=up_mask)
    total = loss_dict["total_loss"] + mask_l
    loss_dict["condinst_loss"] = mask_l
    if sem_loss_on and sem_logits is not None:
        gt_valid = (labels.sum(2) > 0).float()
        sem_l = semantic_focal_loss(sem_logits, masks, labels[..., 0].long(),
                                    gt_valid, sem_logits.shape[1])
        total = total + sem_l
        loss_dict["sem_loss"] = sem_l
    loss_dict["total_loss"] = total
    return total, loss_dict


def uni_mask_loss_fn(model, images, targets, task_ids, masks, img_size,
                     mot_weight=1.0, bidirect=True, use_l1=False, up_rate=8,
                     max_pairs=3, max_inst=24):
    """The VOS + MOTS stage's loss (task 1 = VOS, task 2 = MOTS) of a
    (B, 2, ...) batch -> (total, loss_dict): the VOS slots' loss, and the
    MOTS sample's head loss, CondInst over its foreground anchors and the
    contrastive embedding loss, mixed as (n_vos * vos + n_mots * mots) / B.
    The mask branch runs once, on the second frame's FPN maps."""
    fpn_outs_1, embed_0, embed_1 = uni_forward_embeddings(model, images)
    vos_mask = (task_ids == 1).float()
    mots_mask = (task_ids == 2).float()
    B = global_sum(targets.shape[0], like=targets)
    strides = (8, 16, 32)
    mask_branch_out = model.forward_mask_branch(fpn_outs_1)

    vos_dict = vos_loss(model, mask_branch_out, fpn_outs_1, embed_0, embed_1,
                        targets, masks, img_size, max_pairs=max_pairs,
                        up_rate=up_rate, sample_mask=vos_mask, use_l1=use_l1)

    # MOTS: the MOT head loss with zero priors, CondInst over its fg anchors
    priors = tuple(f.new_zeros((f.shape[0], 1) + tuple(f.shape[2:]))
                   for f in fpn_outs_1)
    flat = flatten_raw_outputs(model.forward_head(fpn_outs_1, priors), "mot")
    hw = flat["hw"]
    xs, ys, ss = level_grids(hw, strides, images.device)
    boxes = decode_boxes(flat["reg_raw"], hw, strides)
    mot_dict, assign = yolox_losses(
        targets[:, 1, :, :5], boxes, flat["obj_logits"], flat["cls_logits"],
        flat["reg_raw"], xs, ys, ss, img_size, use_l1=use_l1,
        sample_mask=mots_mask)
    mask_feats, up_mask, _ = mask_branch_out
    mots_mask_l = condinst_mask_loss(
        flat["ctrl"], mask_feats, assign.fg_mask, assign.matched_gt,
        assign.pred_iou, masks[:, 1], hw, strides, max_inst=max_inst,
        up_masks=up_mask, up_rate=up_rate, sample_mask=mots_mask)
    corr_mot_b = mot_contrastive_loss_single(embed_0.float(), embed_1.float(),
                                             targets, bidirect)
    n_vos, n_mots = global_sum(vos_mask.sum()), global_sum(mots_mask.sum())
    corr_mot = (corr_mot_b * mots_mask).sum() / n_mots.clamp_min(1.0)
    total_mots = mot_dict["total_loss"] + mots_mask_l + corr_mot
    if mot_weight > 1.0:
        total_mots = total_mots + mot_dict["conf_loss"] * (mot_weight - 1.0)

    total = (n_vos * vos_dict["total_loss"] + n_mots * total_mots) / B
    out = {"total_loss": total, "condinst_loss_mots": mots_mask_l,
           "corr_loss_mots": corr_mot}
    out.update({k + "_vos": v for k, v in vos_dict.items()
                if k != "total_loss"})
    out.update({k + "_mots": v for k, v in mot_dict.items()
                if k != "total_loss"})
    return total, out


def _make_step(loss, mesh=None):
    """step(state, *batch): loss(state, *batch) -> backward ->
    state.apply_gradients(); returns (state, detached loss dict).

    With a process group up, the step is data-parallel: the batch is this
    rank's slice of the global batch, the losses normalise by the global
    batch's counts, the gradients are summed over the ranks before the
    update, and the loss dict returned is the global batch's (parallel/
    mesh.py). Given a `mesh` (a ProcessMesh over the whole group, the
    batch sharded over all its axes, as on parallel/multihost.py's pod
    mesh), the gradients are summed over its axes one after the other,
    the innermost first.

    Spans (utils/profiling.py): train.step, and under it train.forward,
    train.backward, train.allreduce (data-parallel only) and
    apply_gradients' train.optimizer."""

    @spanned("train.step")
    def step(state, *batch):
        state.model.zero_grad(set_to_none=True)
        with mesh_mod.data_parallel_step() as dp:
            with span("train.forward"):
                total, loss_dict = loss(state, *batch)
            with span("train.backward"):
                total.backward()
        if dp:
            with span("train.allreduce"):
                mesh_mod.all_reduce_grads(
                    (p for p in state.model.parameters() if p.requires_grad),
                    mesh)
        state.apply_gradients()
        loss_dict = {k: v.detach() for k, v in loss_dict.items()}
        return state, mesh_mod.sum_over_ranks(loss_dict) if dp else loss_dict

    return step


def make_det_train_step(img_size, use_l1=False):
    """step(state, images (B, 3, H, W), labels (B, M, 5))."""
    return _make_step(lambda state, images, labels: det_loss_fn(
        state.model, images, labels, img_size, use_l1))


def make_uni_train_step(img_size, mot_weight=1.0, sot_weight=1.0,
                        bidirect=True, use_l1=False, num_classes=8, mhs=False,
                        mhs_weight=0.5, backbone_map=False, mesh=None):
    """step(state, images (B, 2, 3, H, W), targets (B, 2, M, 6), task_ids
    (B,)). The model is the state's (the JAX factory takes the stateless
    module; here the module holds the parameters). `mesh`: as
    `_make_step`'s."""
    return _make_step(lambda state, images, targets, task_ids: uni_loss_fn(
        state.model, images, targets, task_ids, img_size, mot_weight,
        sot_weight, bidirect, use_l1, num_classes, mhs, mhs_weight,
        backbone_map), mesh)


def make_det_mask_train_step(img_size, use_l1=False, max_inst=24,
                             sem_loss_on=False, boxinst=False,
                             boxinst_warmup_iters=10000, d_rate=4):
    """step(state, images (B, 3, H, W), labels (B, M, 5), masks (B, M, Hm,
    Wm)). With boxinst the pairwise term warms up linearly over
    boxinst_warmup_iters, read from state.step before the update (so that
    a resumed run keeps the schedule)."""

    def loss(state, images, labels, masks):
        warmup = (min(state.step / float(boxinst_warmup_iters), 1.0)
                  if boxinst else 1.0)
        return det_mask_loss_fn(state.model, images, labels, masks, img_size,
                                use_l1, max_inst=max_inst,
                                sem_loss_on=sem_loss_on, boxinst=boxinst,
                                warmup_factor=warmup, d_rate=d_rate)

    return _make_step(loss)


def make_uni_mask_train_step(img_size, mot_weight=1.0, bidirect=True,
                             use_l1=False, up_rate=8, max_inst=24):
    """step(state, images (B, 2, 3, H, W), targets (B, 2, M, 6), task_ids
    (B,), masks (B, 2, M, Hm, Wm))."""
    return _make_step(
        lambda state, images, targets, task_ids, masks: uni_mask_loss_fn(
            state.model, images, targets, task_ids, masks, img_size,
            mot_weight, bidirect, use_l1, up_rate, max_inst=max_inst))
