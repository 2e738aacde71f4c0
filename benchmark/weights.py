"""Weights from the seed, made on the device in one draw.

One normal draw of every parameter's elements (a `torch.Generator` on the
device, seeded with --seed), then each tensor is a slice of it, scaled and
shifted by a rule on its name and shape:

- a tensor of two or more dimensions: N(0, 1 / fan_in), fan_in the product
  of every axis but the first (the port's lecun-normal kernels, untruncated);
- the head's obj and cls prediction biases (SOT branch too): the port's
  prior bias -log(99) plus `prior_raise` (so that random weights give the
  tracker its load of detections, as the repo's smoke run raises them),
  +- 0.1;
- the ConvNeXt layer scales `gamma`: 0.5 +- 0.1 (the port's init is 1e-6 in
  the trunk, which would leave every trunk block, and its dw7x7 kernel,
  without effect on the output);
- other vectors and the head's fuse scales `beta_k`: weights 1 +- 0.1,
  biases 0 +- 0.1.

The same names and shapes give the same tensors, whichever model (the
program's or the reference's) they are loaded into.
"""
from __future__ import annotations

import math

import torch

PRIOR_BIAS = -math.log((1 - 1e-2) / 1e-2)


def _rule(name: str, shape, prior_raise: float):
    """(std, mean) of the tensor `name`."""
    leaf = name.rpartition(".")[2]
    if leaf.startswith("beta_"):
        return 0.1, 1.0
    if len(shape) >= 2:
        return 1.0 / math.sqrt(math.prod(shape[1:])), 0.0
    if leaf == "gamma":
        return 0.1, 0.5
    if leaf == "bias" and name.startswith("head.") and (
            ".cls_preds" in name or ".obj_preds" in name):
        return 0.1, PRIOR_BIAS + prior_raise
    if leaf == "bias":
        return 0.1, 0.0
    return 0.1, 1.0


def seeded_weights(named_shapes, seed: int, device,
                   prior_raise: float) -> dict:
    """{name: fp32 tensor on `device`} for [(name, shape)], from `seed`."""
    named_shapes = [(n, tuple(s)) for n, s in named_shapes]
    total = sum(math.prod(s) for _, s in named_shapes)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2 ** 63)
    flat = torch.randn(total, generator=g, device=device)
    out, off = {}, 0
    for name, shape in named_shapes:
        n = math.prod(shape)
        std, mean = _rule(name, shape, prior_raise)
        out[name] = flat[off:off + n].view(shape).mul_(std).add_(mean)
        off += n
    return out


def load_seeded(model: torch.nn.Module, seed: int, prior_raise: float):
    """Fill every parameter of `model` (already on its device) from the
    seed, in place."""
    params = dict(model.named_parameters())
    dev = next(iter(params.values())).device
    w = seeded_weights([(n, p.shape) for n, p in params.items()], seed, dev,
                       prior_raise)
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(w[n])
    return model
