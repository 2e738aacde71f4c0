"""Reduction of a torch.profiler trace of a stretch of the window to what
the per-layer readers need: the device's busy seconds (the union of the
intervals in which a kernel, copy or set ran), the stretch's length, each
kernel name's launches and device seconds, and the longest idle gaps named
by what the host was doing then (the innermost labelled range and operator
open on the host at the gap's start)."""
from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict

import torch


@contextlib.contextmanager
def profiled(on: bool):
    """Profile the block's CPU and CUDA activity when `on`; yields a dict
    that holds `events` once the block has ended (after a synchronise)."""
    box = {}
    if not on:
        yield box
        return
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        yield box
        torch.cuda.synchronize()
    box["events"] = prof.events()


LABEL = "bench."   # the prefix of the harness's own ranges
NAME_CHARS = 160   # of a kernel's (templated, long) name in the breakdown


def _is_device(e) -> bool:
    return getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA


def reduce(events, window_s: float) -> dict:
    """{"busy_s", "window_s", "kernels": {name: [launches, seconds]},
    "device_ops": [[name, seconds]] (10 largest), "idle_gaps": [[host
    label, seconds]] (10 largest, summed by label)}."""
    dev, host = [], []
    for e in events:
        tr = e.time_range
        if e.name.startswith(LABEL) and _is_device(e):
            continue     # the harness's ranges, mirrored on the device
        if _is_device(e):
            dev.append((tr.start, tr.end, e.name))
        elif tr.end > tr.start:
            host.append((tr.start, tr.end, e.name))
    kernels = defaultdict(lambda: [0, 0.0])
    for s, t, name in dev:
        kernels[name][0] += 1
        kernels[name][1] += (t - s) * 1e-6
    busy = 0.0
    gaps = []
    cur_s = cur_t = None
    for s, t, _ in sorted(dev):
        if cur_t is None:
            cur_s, cur_t = s, t
        elif s > cur_t:
            busy += cur_t - cur_s
            gaps.append((cur_t, s))
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
    if cur_t is not None:
        busy += cur_t - cur_s
    labels = sorted(h for h in host if h[2].startswith(LABEL))
    ops = sorted(h for h in host if not h[2].startswith(LABEL))
    op_starts = [h[0] for h in ops]
    by_label = defaultdict(float)
    for g0, g1 in gaps:
        name = [h[2][len(LABEL):] for h in labels if h[0] <= g0 < h[1]][-1:]
        i = bisect.bisect_right(op_starts, g0)
        for h in reversed(ops[max(0, i - 256):i]):   # the innermost open op
            if h[1] > g0:
                name.append(h[2])
                break
        by_label["/".join(name) or "host"] += (g1 - g0) * 1e-6
    top_ops = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    return {
        "busy_s": busy * 1e-6,
        "window_s": window_s,
        "kernels": dict(kernels),
        "device_ops": [[n[:NAME_CHARS], v[1]] for n, v in top_ops],
        "idle_gaps": sorted(([k, v] for k, v in by_label.items()),
                            key=lambda kv: -kv[1])[:10],
    }


def kernel_time(reduced: dict, symbols) -> tuple:
    """(launches, device seconds) of the kernels whose names contain any of
    `symbols`."""
    n = t = 0
    for name, (k, s) in reduced["kernels"].items():
        if any(sym in name for sym in symbols):
            n += k
            t += s
    return n, t
