"""The uni step's FLOPs (forward and backward, no recompute; flops.py) times
the untraced half's steps/s, as a share of the card's bf16 peak (layer:
model)."""
from benchmark import readers


def read(ctx):
    return readers.mfu_pct(ctx, "flops_per_step", "steps_per_s")
