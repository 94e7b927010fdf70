"""The port's one tracing module, on ``torch.profiler``:

- ``span``: a named region of the program (``dcss.<layer>``) in the
  profiler's trace, a ``record_function`` while a profiler records and a
  shared no-op otherwise;
- ``count``: a number in the same trace, as a zero-length region named
  ``dcss.count.<name>=<n>``, while a profiler records;
- ``trace``: a ``torch.profiler`` trace of the CPU and, on the card, CUDA
  activity, written as a TensorBoard trace under ``log_dir`` (``--trace``).

Spans and counts are the profiler's user annotations, so it writes them on
the clock of the device activity it records and ties each launch to the
span it was made in. "On" is a profiler recording: the benchmark's traced
stretch or the trainers' ``--trace``. Off, a span costs one attribute read.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

_OFF = contextlib.nullcontext()
COUNT_PREFIX = "dcss.count."


def span(name: str):
    """``record_function(name)`` while a profiler records (the flag
    ``torch.profiler.profile`` sets while it is open), else a shared no-op
    context."""
    if _autograd_profiler._is_profiler_enabled:
        return _autograd_profiler.record_function(name)
    return _OFF


def count(name: str, n) -> None:
    """Writes ``n`` into the trace as ``dcss.count.<name>=<n>`` while a
    profiler records; nothing otherwise."""
    if _autograd_profiler._is_profiler_enabled:
        with _autograd_profiler.record_function(f"{COUNT_PREFIX}{name}={n}"):
            pass


@contextlib.contextmanager
def trace(log_dir: str, device: Optional[str] = None) -> Iterator[None]:
    """A ``torch.profiler`` trace of the block into ``log_dir`` (open with
    TensorBoard's profiler plugin or ``chrome://tracing``); it holds the
    program's ``dcss.*`` spans and counts."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
