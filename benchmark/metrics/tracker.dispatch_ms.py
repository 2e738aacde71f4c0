"""Median host ms a profiled tick spends in the program's `tracker.step`
span less its `tracker.sync` spans: the host's time issuing the device
tracker's work (layer: tracker)."""
from benchmark import spans


def read(ctx):
    return spans.median_per_root(
        ctx, "mot.tick",
        lambda recs, root: (
            spans.named_ms(recs, root, ("tracker.step",))
            - spans.named_ms(recs, root, ("tracker.sync",),
                             within="tracker.step")))
