"""What the port's model tools share: the model of an exp with its
weights from a checkpoint of the port's Trainer, else the exp's seeded
init."""
from __future__ import annotations

import os

import torch

from ..core.checkpoint import load_checkpoint


def load_model(exp, ckpt=None, serve: bool = False):
    """exp.get_model (seed 0; serve=True: the served model, bf16
    interaction where the exp says serve_interact_bf16), its weights
    replaced by the checkpoint's EMA weights (else its weights) when
    `ckpt` names one. On the CPU, in eval mode: the drivers move it."""
    gen = torch.Generator().manual_seed(0)
    # the det exps' get_model has no serve argument
    model = exp.get_model(gen, serve=True) if serve else exp.get_model(gen)
    if ckpt:
        state = load_checkpoint(os.path.dirname(ckpt) or ".",
                                os.path.basename(ckpt))
        model.load_state_dict(state.get("ema_model") or state["model"])
    return model.eval()
