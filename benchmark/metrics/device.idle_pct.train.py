"""The share of the profiled steps with nothing running on the card (layer:
device)."""
from benchmark import readers


def read(ctx):
    return readers.idle_pct(ctx)
