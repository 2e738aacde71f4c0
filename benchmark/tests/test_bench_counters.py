"""The readers of the program's tracker counters: a number where the
counter is kept, None where it is not (a program older than the counter)."""
from __future__ import annotations

import os

import pytest

from benchmark import harness


def _read(metric, ctx):
    path = os.path.join(harness.BENCH, "metrics", metric + ".py")
    return harness.load_module(path).read(ctx)


def test_fused_steps_per_tick_reads_the_counter_or_none():
    m = "tracker.fused_steps_per_tick"
    kept = {"counters": {"calls": 0, "rounds": 0, "syncs": 0,
                         "fused_steps": 40, "ticks": 40}}
    assert _read(m, kept) == pytest.approx(1.0)
    older = {"counters": {"calls": 120, "rounds": 400, "syncs": 220,
                          "ticks": 40}}
    assert _read(m, older) is None
    assert _read(m, {"counters": {"fused_steps": 0, "ticks": 0}}) is None
    assert _read(m, {}) is None
    # the syncs reader reads 0 where the kernel ran every step
    assert _read("tracker.syncs_per_tick", kept) == 0
