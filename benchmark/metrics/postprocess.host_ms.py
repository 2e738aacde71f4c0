"""Median host ms a profiled tick spends in the program's
`postprocess.decode` and `postprocess.nms` spans (layer: postprocess)."""
from benchmark import spans


def read(ctx):
    return spans.median_per_root(
        ctx, "mot.tick",
        lambda recs, root: spans.named_ms(
            recs, root, ("postprocess.decode", "postprocess.nms")))
