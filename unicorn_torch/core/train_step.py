"""Train-step factories for the det and uni stages (port of
unicorn_tpu/core/train_step.py; the mask steps are not ported yet).

The uni step stacks the two frames into one 2B batch through the backbone,
runs the interaction and the embedding upsample in fp32, builds the SOT
priors by correlation propagation, calls the unified head once and sums the
masked task losses. On the card every kernel of the model and the three
correlation training kernels run in the forward and in the backward.

Layout: images (B, 2, 3, H, W), as the port's models take NCHW (the JAX
package takes (B, 2, H, W, 3)); targets (B, 2, M, 6) and task_ids (B,) as
there. A step function takes (state, images, targets, task_ids), all on the
state's device, updates the state in place and returns (state, loss_dict).
"""
from __future__ import annotations

import torch

from ..losses.det import yolox_losses
from ..losses.uni import (build_mhs_labels, build_sot_priors,
                          unicorn_uni_loss)
from ..models.heads import decode_boxes, flatten_raw_outputs, level_grids
from ..ops.correlation import resize_bilinear_torch


def det_loss_fn(model, images, labels, img_size, use_l1=False,
                strides=(8, 16, 32)):
    """Detection pretraining loss. images (B, 3, H, W); labels (B, M, 5)."""
    head_raw = model(images)[0]
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
    features are cast to fp32 for the interaction."""
    if backbone_map:
        raise NotImplementedError("uni_forward_embeddings(backbone_map=True) "
                                  "is not yet ported")
    B, n_frames = images.shape[:2]
    assert n_frames == 2
    imgs_flat = images.transpose(0, 1).reshape(2 * B, *images.shape[2:])
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
        B = targets.shape[0]
        n_mhs = (mhs_task == 1).float().sum().clamp_min(1.0)
        mhs_loss = mhs_dict["total_loss"] * B / n_mhs
        total = total + mhs_weight * mhs_loss
        loss_dict["mhs_loss"] = mhs_loss
        loss_dict["total_loss"] = total
    return total, loss_dict


def _make_step(loss):
    """step(state, *batch): loss(state.model, *batch) -> backward ->
    state.apply_gradients(); returns (state, detached loss dict)."""

    def step(state, *batch):
        state.model.zero_grad(set_to_none=True)
        total, loss_dict = loss(state.model, *batch)
        total.backward()
        state.apply_gradients()
        return state, {k: v.detach() for k, v in loss_dict.items()}

    return step


def make_det_train_step(img_size, use_l1=False):
    """step(state, images (B, 3, H, W), labels (B, M, 5))."""
    return _make_step(lambda model, images, labels: det_loss_fn(
        model, images, labels, img_size, use_l1))


def make_uni_train_step(img_size, mot_weight=1.0, sot_weight=1.0,
                        bidirect=True, use_l1=False, num_classes=8, mhs=False,
                        mhs_weight=0.5, backbone_map=False):
    """step(state, images (B, 2, 3, H, W), targets (B, 2, M, 6), task_ids
    (B,)). The model is the state's (the JAX factory takes the stateless
    module; here the module holds the parameters)."""
    return _make_step(lambda model, images, targets, task_ids: uni_loss_fn(
        model, images, targets, task_ids, img_size, mot_weight, sot_weight,
        bidirect, use_l1, num_classes, mhs, mhs_weight, backbone_map))
