"""The training correlation kernels' (fwd_lse, bwd_i, bwd_j) summed least time
over their device time in the profiled steps (layer: kernels)."""
from benchmark import readers


def read(ctx):
    return readers.correlation_train_roofline_pct(ctx)
