"""Profiling and tracing helpers (port of unicorn_tpu/utils/profiling.py):
torch.profiler traces, named regions, the data-time / step-time split the
reference logs, and the card's memory counters."""
from __future__ import annotations

import contextlib
import time

import torch
from torch.profiler import (ProfilerActivity, profile, record_function,
                            tensorboard_trace_handler)


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace a block with torch.profiler, the CUDA activity too where a card
    is present, and write it as a Chrome trace
    <log_dir>/<host>_<pid>.<ms>.pt.trace.json:
    with trace('traces'): step(...)"""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


@contextlib.contextmanager
def annotate(name: str):
    """A named region in the trace."""
    with record_function(name):
        yield


def _cuda_devices(obj, found: set):
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            found.add(obj.device)
    elif isinstance(obj, dict):
        for v in obj.values():
            _cuda_devices(v, found)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _cuda_devices(v, found)
    return found


class StepTimer:
    """data-time / step-time split (the reference's trainer.py:172-190)."""

    def __init__(self):
        self.data_time = 0.0
        self.step_time = 0.0
        self.n = 0
        self._t = time.perf_counter()

    def mark_data(self):
        t = time.perf_counter()
        self.data_time += t - self._t
        self._t = t

    def mark_step(self, sync_obj=None):
        """Ends a step; with sync_obj (a tensor, or lists, tuples and dicts
        of them) the CUDA devices it lies on are synchronised first, so that
        the step's time includes its device work."""
        for dev in _cuda_devices(sync_obj, set()):
            torch.cuda.synchronize(dev)
        t = time.perf_counter()
        self.step_time += t - self._t
        self._t = t
        self.n += 1

    def summary(self):
        n = max(self.n, 1)
        return {"data_ms": 1e3 * self.data_time / n,
                "step_ms": 1e3 * self.step_time / n}


def device_memory_stats():
    """{"cuda:i": {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}} for
    each card (the caching allocator's current and peak allocations, and
    the card's total memory); {} without a card."""
    out = {}
    for i in range(torch.cuda.device_count() if torch.cuda.is_available()
                   else 0):
        s = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": s.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.mem_get_info(i)[1],
        }
    return out
