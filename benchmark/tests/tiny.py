"""The two cells cut to a size the CPU runs in seconds (for the tests
only): ConvNeXt-Tiny's widths at 64 x 96, two streams of 72 x 128 frames,
small pipeline buffers. The limits are the cells' own."""
from __future__ import annotations

import types

import torch

from benchmark import harness

SEED = 2 ** 31 + 7


def tiny_cell(workload: str) -> harness.Cell:
    cell = harness.Cell(workload, harness.manifest())
    cell.cfg = harness.load_json(
        harness.BENCH + "/configs/unicorn_track_tiny.json")
    cell.cfg["exp_fields"].update(input_size=[64, 96], test_size=[64, 96])
    if cell.traffic["kind"] == "mot_streams":
        # at this size the cell's raise leaves no detection above the
        # tracker's threshold; the repo's smoke run's raise fills its slots,
        # so that the tracker confirms tracks and an altered one shows
        cell.cfg["prior_raise"] = 6.0
        cell.traffic.update(streams=2, frame_hw=[72, 128], ring=3, objects=4,
                            object_px=[8, 24], warmup_ticks=1,
                            profile_ticks=2, timed_ticks=2)
        cell.traffic["pipeline"].update(max_dets=32, max_tracks=32,
                                        n_cand=64)
    else:
        cell.cfg["exp_fields"]["remat"] = True
        cell.traffic.update(ring=4, objects={"1": 1, "2": 4},
                            object_px=[8, 24], profile_steps=1)
    return cell


def run_cpu(cell, seconds=2.0, trace=0, seed=SEED) -> dict:
    """The cell's kind on the CPU, skipping the look for a card."""
    args = types.SimpleNamespace(seed=seed, seconds=seconds, trace=trace)
    return cell.kind().run(cell, args, device=torch.device("cpu"),
                           start_wall=harness.process_start_wall())


def failed(out) -> dict:
    """{name: value} of the checks above their limits."""
    return {n: v for n, v, lim in out["checks"] if not v <= lim}
