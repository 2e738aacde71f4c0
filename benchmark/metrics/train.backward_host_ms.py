"""Median host ms a profiled step spends in the program's `train.backward`
span together with the op ranges the autograd engine's thread opens inside
it, counted once (layer: train step)."""
from benchmark import spans


def read(ctx):
    return spans.median_per_root(
        ctx, "train.step",
        lambda recs, root: spans.with_other_threads_ms(
            recs, root, "train.backward"))
