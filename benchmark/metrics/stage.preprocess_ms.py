"""Median host ms a tick of the upload and letterbox, synchronised (layer:
preprocess)."""
from benchmark import readers


def read(ctx):
    return readers.median_span(ctx, "preprocess")
