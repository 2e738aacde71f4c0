"""Each hand-written kernel's least time on the card, from the call shapes a
configuration fixes: every input byte read once and every output byte
written once at the memory rate, or the operations at the highest published
peak at which their precision can be computed (bf16 operands: the tensor
cores' bf16 rate; fp32 work: the fp32 rate, TF32 not counted), whichever is
longer. No implementation of the same work can beat it, so a share of it
cannot pass 100%. The arithmetic is that of the repo's chip_smoke.py
(`roofline`, the dw7x7 and correlation phases), with the dw7x7 operations
taken against the bf16 peak where its operands are bf16.
"""
from __future__ import annotations

from .reference.model import CONVNEXT

BF16, FP32 = 2, 4   # bytes an element


def bound_s(nbytes: float, flops: float, bytes_per_s: float,
            flops_per_s: float) -> float:
    return max(nbytes / bytes_per_s, flops / flops_per_s)


def dw7x7_calls(exp: dict, batch: int, mode: str):
    """[((B, H, W, C), launches)] of the dw7x7 kernel a unit of work: a
    serving tick of `batch` frames (mode "serve"), or a uni training step of
    `batch` pairs (mode "train": the trunk on both frames, again in the
    backward under remat; the head twice, main and MOT-helps-SOT)."""
    H, W = exp["input_size"]
    depths, dims = CONVNEXT[exp["backbone_name"]]
    hidden = int(256 * exp["width"])
    trunk_b = batch if mode == "serve" else 2 * batch
    trunk_n = 1 if mode == "serve" or not exp["remat"] else 2
    head_n = 1 if mode == "serve" else 2
    calls = [((trunk_b, H // (4 << i), W // (4 << i), dims[i]),
              depths[i] * trunk_n) for i in range(4)]
    calls += [((batch, H // s, W // s, hidden), exp["n_layer_att"] * head_n)
              for s in (8, 16, 32)]
    return calls


def dw7x7_bound_per_launch(calls, peaks: dict, esz: int = BF16) -> float:
    """The mean least time of one launch over `calls` (bf16 operands)."""
    total = n = 0
    for (B, H, W, C), k in calls:
        numel = B * H * W * C
        total += k * bound_s((2 * numel + 50 * C) * esz, 2 * 49 * numel,
                             peaks["bytes_per_s"], peaks["bf16_flops"])
        n += k
    return total / n


def correlation_train_bounds(exp: dict, pairs: int, peaks: dict) -> dict:
    """{kernel: least seconds of one launch} of the three fp32 training
    correlation kernels at one step's shape: B pairs, N stride-8 cells,
    C = embed_dim channels, K = 1 label map."""
    H, W = exp["input_size"]
    B, N, C, K = pairs, (H // 8) * (W // 8), exp["embed_dim"], 1
    nb_in = (2 * B * N * C + B * K * N) * FP32
    nb_bwd = nb_in + (B * N + B * K * N + B * N) * FP32
    work = {
        "fwd_lse": (nb_in + (B * K * N + B * N) * FP32,
                    2 * B * N * N * (C + K)),
        "bwd_i": (nb_bwd + (B * N * C + B * K * N) * FP32,
                  2 * B * N * N * (2 * C + 2 * K)),
        "bwd_j": (nb_bwd + B * N * C * FP32, 2 * B * N * N * (2 * C + K)),
    }
    return {k: bound_s(nb, fl, peaks["bytes_per_s"], peaks["fp32_flops"])
            for k, (nb, fl) in work.items()}
