"""Median host ms a tick of MultiStreamMOT's detect stage (forward, decode,
NMS), synchronised (layer: driver, model, postprocess)."""
from benchmark import readers


def read(ctx):
    return readers.median_span(ctx, "detect")
