"""Windowed meters (port of unicorn_tpu/utils/meters.py)."""
from __future__ import annotations

from collections import defaultdict, deque

import numpy as np


class AverageMeter:
    """Tracks a windowed average of a series."""

    def __init__(self, window_size: int = 50):
        self._deque = deque(maxlen=window_size)
        self._total = 0.0
        self._count = 0

    def update(self, value):
        self._deque.append(float(value))
        self._count += 1
        self._total += float(value)

    @property
    def median(self):
        return float(np.median(self._deque)) if self._deque else 0.0

    @property
    def avg(self):
        return float(np.mean(self._deque)) if self._deque else 0.0

    @property
    def global_avg(self):
        return self._total / max(self._count, 1)

    @property
    def latest(self):
        return self._deque[-1] if self._deque else None

    def reset(self):
        self._deque.clear()
        self._total = 0.0
        self._count = 0


class MeterBuffer(defaultdict):
    def __init__(self, window_size: int = 20):
        super().__init__(lambda: AverageMeter(window_size))

    def update(self, values=None, **kwargs):
        values = {**(values or {}), **kwargs}
        for k, v in values.items():
            self[k].update(v)

    def get_filtered_meter(self, filter_key: str = "time"):
        return {k: v for k, v in self.items() if filter_key in k}

    def clear_meters(self):
        for v in self.values():
            v.reset()
