"""The dw7x7 kernel's least time over its device time in the profiled steps:
the forward, the remat recompute and the head (layer: kernels)."""
from benchmark import readers


def read(ctx):
    return readers.dw7x7_roofline_pct(ctx)
