"""Median host ms a profiled tick waits in the program's `tracker.sync`
spans, the reads of the auction's loop condition (layer: tracker)."""
from benchmark import spans


def read(ctx):
    return spans.median_per_root(
        ctx, "mot.tick",
        lambda recs, root: spans.named_ms(recs, root, ("tracker.sync",)))
