"""Median host ms a profiled tick spends in the program's `model.forward`
span (the served forward: trunk, neck and head dispatched), from the
program's spans (layer: model)."""
from benchmark import spans


def read(ctx):
    return spans.median_per_root(
        ctx, "mot.tick",
        lambda recs, root: spans.named_ms(recs, root, ("model.forward",)))
