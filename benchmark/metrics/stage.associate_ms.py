"""Median host ms a tick of the associate stage (the device tracker's step),
synchronised (layer: tracker)."""
from benchmark import readers


def read(ctx):
    return readers.median_span(ctx, "associate")
