"""Tracker steps a tick that ran as the device tracker's one-launch kernel,
from the program's own counters over the window (layer: tracker). None where
the program keeps no such counter."""


def read(ctx):
    c = ctx.get("counters") or {}
    steps = c.get("fused_steps")
    return steps / c["ticks"] if steps is not None and c.get("ticks") else None
