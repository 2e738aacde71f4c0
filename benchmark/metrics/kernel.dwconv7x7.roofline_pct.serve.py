"""The dw7x7 kernel's least time (roofline.py) over its device time in the
profiled ticks (layer: kernels)."""
from benchmark import readers


def read(ctx):
    return readers.dw7x7_roofline_pct(ctx)
