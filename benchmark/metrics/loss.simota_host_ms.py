"""Median host ms a profiled step spends in the program's `loss.simota`
spans, SimOTA's assignment (layer: losses)."""
from benchmark import spans


def read(ctx):
    return spans.median_per_root(
        ctx, "train.step",
        lambda recs, root: spans.named_ms(recs, root, ("loss.simota",)))
