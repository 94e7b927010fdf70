"""The program's own spans and counts in a traced run. The port names its
layers ``dcss.<layer>`` (``record_function`` spans, ``utils/profiling.py``)
and writes a count as a zero-length span ``dcss.count.<name>=<n>``; a
program without them gives these readers nothing to read, and they return
None."""

from __future__ import annotations

from typing import Optional

PREFIX = "dcss."
COUNT = "dcss.count."
# the host's waits on the card: the runtime's synchronising calls
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")


def _annotations(trace):
    return [(name, s, d) for cat, name, s, d in trace.host if cat == "user_annotation"]


def device_ms(rec, kind: str, name: str) -> Optional[float]:
    """Device milliseconds an iteration of the operations launched inside
    the program's span ``name``, in a run of ``kind``."""
    if rec.kind != kind or rec.trace is None:
        return None
    return rec.trace.device_ms(lambda n: n == name)


def syncs(rec, kind: str) -> Optional[float]:
    """The host's waits on the card an iteration (``SYNCS``) that start
    inside one of the program's spans; the benchmark's own waits lie
    outside them. None where the trace holds no span of the program."""
    if rec.kind != kind or rec.trace is None:
        return None
    ranges = [(s, s + d) for name, s, d in _annotations(rec.trace)
              if name.startswith(PREFIX) and not name.startswith(COUNT)]
    if not ranges:
        return None
    n = sum(1 for cat, name, s, _ in rec.trace.host
            if cat == "cuda_runtime" and name in SYNCS and any(a <= s <= b for a, b in ranges))
    return n / max(rec.trace.iterations, 1)


def counted(rec, kind: str, name: str) -> Optional[float]:
    """The sum of the program's counts ``name`` an iteration; None where
    it wrote none."""
    if rec.kind != kind or rec.trace is None:
        return None
    head = f"{COUNT}{name}="
    values = [float(n[len(head):]) for n, _, _ in _annotations(rec.trace) if n.startswith(head)]
    if not values:
        return None
    return sum(values) / max(rec.trace.iterations, 1)
