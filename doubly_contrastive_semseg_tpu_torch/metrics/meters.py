"""Running meters (reference ``metrics/stream_metrics.py:96-133``); the
port's own copy of the JAX package's ``metrics/meters.py``."""

from __future__ import annotations

import time
from collections import defaultdict


class AverageMeter:
    """Keyed running averages (reference ``AverageMeter``)."""

    def __init__(self):
        self.book = defaultdict(lambda: [0.0, 0])

    def reset_all(self):
        self.book.clear()

    def reset(self, id_):
        self.book.pop(id_, None)

    def update(self, id_, val):
        rec = self.book[id_]
        rec[0] += val
        rec[1] += 1

    def get_results(self, id_):
        total, count = self.book[id_]
        return total / count if count else 0.0


class TimeAverageMeter:
    """Scalar running average with last value (reference ``TimeAverageMeter``)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


class Timer:
    """Context-manager wall-clock timer for step instrumentation."""

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.start
        return False
