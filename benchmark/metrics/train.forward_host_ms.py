"""Median host ms a profiled step spends in the program's `train.forward`
span, the loss function (layer: train step)."""
from benchmark import spans


def read(ctx):
    return spans.median_per_root(
        ctx, "train.step",
        lambda recs, root: spans.named_ms(recs, root, ("train.forward",)))
