"""The model's FLOPs a frame (flops.py) times the frames/s of the window's
untraced first third, as a share of the card's bf16 peak (layer: model)."""
from benchmark import readers


def read(ctx):
    return readers.mfu_pct(ctx, "flops_per_frame", "frames_per_s")
