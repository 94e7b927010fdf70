"""Step timing and device traces — port of the JAX package's
``utils/profiling.py`` on ``torch.profiler``:

- ``StepTimer``: wall-clock step times, each closed by a synchronise of the
  card (``fence`` a device or tensor) so the time covers the device work;
- ``trace``: a ``torch.profiler`` trace of the CPU and, on the card, CUDA
  activity, written as a TensorBoard trace under ``log_dir`` (``--trace``);
- ``annotate``: a named region in that trace (``record_function``).
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

import torch


class StepTimer:
    """Rolling stats of fenced step times."""

    def __init__(self, skip_first: int = 1):
        self.skip_first = skip_first
        self.times: list = []
        self._seen = 0

    @contextlib.contextmanager
    def measure(self, fence=None) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        device = getattr(fence, "device", fence)
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        self._seen += 1
        if self._seen > self.skip_first:
            self.times.append(dt)

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else 0.0

    def report(self, per: int = 1) -> str:
        return f"{self.mean / per * 1000:.2f} ms" if self.times else "n/a"


@contextlib.contextmanager
def trace(log_dir: str, device: Optional[str] = None) -> Iterator[None]:
    """A ``torch.profiler`` trace of the block into ``log_dir`` (open with
    TensorBoard's profiler plugin or ``chrome://tracing``)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def annotate(name: str):
    return torch.profiler.record_function(name)
