"""The model's floating-point operations a unit of work, counted once from
the plain reference at the cell's shapes on the meta device
(`torch.utils.flop_counter.FlopCounterMode`: convolutions, matrix products
and attention; elementwise work is not counted). The count is the work's,
whatever implements it, and has no recomputation in it."""
from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode, conv_flop_count

from .reference import model as ref_model
from .reference import train as ref_train


def _conv_backward_flop(grad_out_shape, x_shape, w_shape, _bias, _stride,
                        _padding, _dilation, transposed, _output_padding,
                        _groups, output_mask, out_shape=None):
    """A convolution's gradient with respect to its input and to its weight
    each takes the forward's multiply-adds. (The counter's own formula
    leaves the groups out, which counts a depthwise convolution's gradient
    C + 1 times over.)"""
    fwd = conv_flop_count(x_shape, w_shape, grad_out_shape, transposed)
    return fwd * (int(output_mask[0]) + int(output_mask[1]))


def _counter():
    return FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten.convolution_backward: _conv_backward_flop})


def serve_flops_per_frame(cfg: dict) -> float:
    """forward_whole of one frame at the configuration's input size."""
    H, W = cfg["exp_fields"]["input_size"]
    with torch.device("meta"):
        m = ref_model.Unicorn(**ref_model.model_args(cfg["exp_fields"]))
        x = torch.empty(1, 3, H, W)
        with _counter() as fc, torch.no_grad():
            m.forward_whole(x)
    return float(fc.get_total_flops())


def train_flops_per_step(cfg: dict, pairs: int, max_labels: int) -> float:
    """The uni loss, forward and backward, of `pairs` image pairs (one SOT
    and one MOT pair alternate; the shapes, and so the count, are the
    same)."""
    e = cfg["exp_fields"]
    H, W = e["input_size"]
    with torch.device("meta"):
        m = ref_model.Unicorn(**ref_model.model_args(e, remat=False))
        images = torch.empty(pairs, 2, 3, H, W)
        targets = torch.zeros(pairs, 2, max_labels, 6)
        task_ids = torch.ones(pairs, dtype=torch.int64)
        with _counter() as fc:
            total, _ = ref_train.uni_loss(
                m, images, targets, task_ids, tuple(e["input_size"]),
                float(e["mot_weight"]) if e["scale_all_mot"] else 1.0,
                e["bidirect"], e["always_l1"])
            total.backward()
    return float(fc.get_total_flops())
