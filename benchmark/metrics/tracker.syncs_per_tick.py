"""Host synchronisations a tick in the device tracker's auction, from the
program's own counters over the window (layer: tracker)."""
from benchmark import readers


def read(ctx):
    return readers.per_tick(ctx, "syncs")
