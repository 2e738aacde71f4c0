"""What the readers of the program's spans share. The program opens a span
(`unicorn_torch/utils/profiling.py` `span`) at each layer boundary while a
torch profiler is on, so the records of a --trace 1 run are those of its
profiled stretch: a record has `name`, `parent` and `root` (indices into
the list; parent -1 on a root, which is its own root), `start_ns`,
`end_ns` (`time.perf_counter_ns`) and `thread`.

A reader takes the roots of one name (`mot.tick`, `train.step`: one a
profiled tick or step), measures each from the spans under it, and reports
the median over the roots, in ms. A run of a program without spans, or of
one that recorded none, reads None.
"""
from __future__ import annotations

import statistics


def records(ctx):
    """The run's span records: ctx["span_records"] where the kind hands
    them over, else the program's own (`profiling.spans()`); None where the
    program keeps none."""
    if "span_records" in ctx:
        return ctx["span_records"]
    try:
        from unicorn_torch.utils import profiling
    except ImportError:
        return None
    get = getattr(profiling, "spans", None)
    return list(get()) if get is not None else None


def _ms(r) -> float:
    return (r.end_ns - r.start_ns) * 1e-6


def under(recs, root: int) -> list:
    """The indices of the spans of `root`'s tree, the root's own first."""
    return [i for i, r in enumerate(recs) if r.root == root]


def has_ancestor(recs, i: int, name: str) -> bool:
    j = recs[i].parent
    while j >= 0:
        if recs[j].name == name:
            return True
        j = recs[j].parent
    return False


def named_ms(recs, root: int, names, within: str | None = None) -> float:
    """ms of the spans of `root`'s tree named in `names` (optionally only
    those under a span named `within`). Spans of one name do not nest."""
    return sum(_ms(recs[i]) for i in under(recs, root)
               if recs[i].name in names
               and (within is None or has_ancestor(recs, i, within)))


def self_ms(recs, i: int) -> float:
    """A span's self time: its ms less its children's."""
    return _ms(recs[i]) - sum(_ms(r) for r in recs if r.parent == i)


def union_ms(intervals) -> float:
    """ms covered by the union of (start_ns, end_ns) intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total * 1e-6


def with_other_threads_ms(recs, root: int, name: str) -> float:
    """ms covered by the spans named `name` in `root`'s tree together with
    the roots that other threads opened inside them (the autograd engine's
    thread runs a backward's op ranges as trees of their own): the union of
    the intervals, so that the caller's wait and the engine's work inside
    it count once."""
    own = [recs[i] for i in under(recs, root) if recs[i].name == name]
    thread = recs[root].thread
    spans = [(r.start_ns, r.end_ns) for r in own]
    for r in recs:
        if (r.parent == -1 and r.thread != thread and r.end_ns is not None
                and any(s <= r.start_ns < e for s, e in spans)):
            spans.append((r.start_ns, r.end_ns))
    return union_ms(spans)


def median_per_root(ctx, root_name: str, measure):
    """The median over the closed roots named `root_name` of
    measure(recs, root index); None without such a root."""
    recs = records(ctx)
    if not recs:
        return None
    roots = [i for i, r in enumerate(recs)
             if r.parent == -1 and r.name == root_name
             and r.end_ns is not None]
    if not roots:
        return None
    return statistics.median(measure(recs, i) for i in roots)
