"""Profiling and tracing helpers (port of unicorn_tpu/utils/profiling.py):
torch.profiler traces, the program's spans, and the card's memory counters.

A span names a stretch of the host's work: `with span("tracker.step"):`.
It costs a flag read unless a torch profiler is on in the process; the
profiler is the switch (`trace(log_dir)` turns it on for a block). With the
profiler on, a span

- opens an op-scope profiler range (`_RecordFunctionFast`), which lies on
  the profiler's clock beside the device's work and, unlike
  `record_function`'s user annotation, is not mirrored onto the device's
  timeline, so it never counts as device work;
- appends a `SpanRecord` to a bounded list in memory (`spans()`): its name,
  the index of its parent and of its root (per thread: a span opened on
  the autograd engine's thread roots a tree of its own), its host start and
  end in `time.perf_counter_ns()` and its thread. Past `MAX_SPANS` records
  a span is counted in `dropped()` instead.

A span never synchronises, allocates on the device or changes stream order.
"""
from __future__ import annotations

import contextlib
import functools
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

MAX_SPANS = 1 << 17

# an op-scope range: recorded as a CPU op, with no device mirror
_RANGE = torch._C._profiler._RecordFunctionFast
_NULL = contextlib.nullcontext()


class SpanRecord:
    """One span: `parent` and `root` index `spans()` (parent -1 on a root,
    whose `root` is its own index); `end_ns` is None while it is open."""
    __slots__ = ("name", "parent", "root", "start_ns", "end_ns", "thread")

    def __init__(self, name, parent, root, start_ns, thread):
        self.name, self.parent, self.root = name, parent, root
        self.start_ns, self.end_ns, self.thread = start_ns, None, thread

    def __repr__(self):
        return (f"SpanRecord({self.name!r}, parent={self.parent}, "
                f"root={self.root}, {self.start_ns}..{self.end_ns}, "
                f"thread={self.thread})")


_records: list = []
_dropped = 0
_generation = 0                 # advanced by clear_spans()
_lock = threading.Lock()
_local = threading.local()      # .stack: (index, record) of the open spans


class _Span:
    __slots__ = ("name", "rec", "gen", "range")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        global _dropped
        if getattr(_local, "gen", None) != _generation:
            _local.stack, _local.gen = [], _generation
        stack = _local.stack
        with _lock:
            idx = len(_records)
            if idx < MAX_SPANS:
                parent, root = (stack[-1][0], stack[-1][1].root) if stack \
                    else (-1, idx)
                rec = SpanRecord(self.name, parent, root, 0,
                                 threading.get_ident())
                _records.append(rec)
            else:
                rec = None
                _dropped += 1
        self.rec, self.gen = rec, _local.gen
        if rec is not None:
            stack.append((idx, rec))
        self.range = _RANGE(self.name)
        self.range.__enter__()
        if rec is not None:
            rec.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.rec is not None:
            self.rec.end_ns = time.perf_counter_ns()
            if _local.gen == self.gen:
                _local.stack.pop()
        self.range.__exit__(*exc)
        return False


def span(name: str):
    """A named span of host work (module docstring): a shared null context
    unless a torch profiler is on."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return _Span(name)


def spanned(name: str):
    """Decorator: the whole call of the function is the span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def spans() -> list:
    """The SpanRecords kept since the last `clear_spans()` (the list
    itself, in opening order)."""
    return _records


def dropped() -> int:
    """Spans left out since the last `clear_spans()` as the list was
    full."""
    return _dropped


def clear_spans():
    """Empty the records; spans open now are left out of the new list."""
    global _dropped, _generation
    with _lock:
        _records.clear()
        _dropped = 0
        _generation += 1


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace a block with torch.profiler, the CUDA activity too where a card
    is present, and write it as a Chrome trace
    <log_dir>/<host>_<pid>.<ms>.pt.trace.json; the span records start
    empty: with trace('traces'): step(...)"""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    clear_spans()
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


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
