"""The traced window: ``torch.profiler`` over a few iterations, its Chrome
trace written under ``perfbench/out/`` and read back into device
operations, the busy time, the longest idle gaps by what the host was doing
then, the device operations that took most time, and the device time of
the operations launched inside a host span (each device operation is tied
to its launch on the host by the profiler's correlation id)."""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List, Optional, Tuple

WINDOW = "perfbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


@dataclass
class Trace:
    ops: List[Tuple[str, float, float, str]]     # device ops: (name, start µs, dur µs, cat)
    host: List[Tuple[str, str, float, float]]    # host events: (cat, name, start µs, dur µs)
    start: float                                 # the traced window, µs
    end: float
    iterations: int
    launched: List[Optional[float]]              # each op's launch on the host, µs, or None

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    def intervals(self):
        out = []
        for _, t, d, _ in sorted(self.ops, key=lambda o: o[1]):
            a, b = max(t, self.start), min(t + d, self.end)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.intervals()) * 1e-6

    def kernels(self, match: Callable[[str], bool]) -> List[float]:
        """The durations (µs) of the device operations whose name matches."""
        return [d for n, _, d, cat in self.ops if cat == "kernel" and match(n)]

    def device_ms(self, span: Callable[[str], bool]) -> Optional[float]:
        """Device milliseconds an iteration of the operations launched while
        a host span (``record_function``) whose name ``span`` matches was
        open; None where no operation was."""
        ranges = [(s, s + d) for cat, name, s, d in self.host
                  if cat == "user_annotation" and name != WINDOW and span(name)]
        total, found = 0.0, False
        for (_, _, dur, _), at in zip(self.ops, self.launched):
            if at is not None and any(a <= at <= b for a, b in ranges):
                total += dur
                found = True
        return total * 1e-3 / max(self.iterations, 1) if found else None

    def launches(self) -> int:
        """The kernels in the window."""
        return sum(1 for _, t, _, cat in self.ops
                   if cat == "kernel" and self.start <= t <= self.end)

    def top_ops(self, k: int = 10) -> List[list]:
        total = {}
        for n, _, d, _ in self.ops:
            total[n] = total.get(n, 0.0) + d
        top = sorted(total.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:160], d * 1e-6] for n, d in top]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """The ``k`` longest stretches of the window with no device
        operation, each named by the innermost benchmark span and host
        operation that covered its middle."""
        iv = self.intervals()
        edges = [self.start] + [x for a, b in iv for x in (a, b)] + [self.end]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:k]:
            mid = 0.5 * (a + b)
            span = self._innermost(mid, ("user_annotation",), exclude=WINDOW)
            op = self._innermost(mid, ("cpu_op", "cuda_runtime", "cuda_driver"))
            name = "/".join(x for x in (span, op) if x) or "host idle"
            out.append([name[:160], (b - a) * 1e-6])
        return out

    def _innermost(self, t: float, cats, exclude: str = "") -> str:
        best, best_d = "", float("inf")
        for cat, name, s, d in self.host:
            if cat in cats and s <= t <= s + d and d < best_d and name != exclude:
                best, best_d = name, d
        return best


def read_chrome_trace(path: Path, iterations: int) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ops, host, op_ids, launch_at = [], [], [], {}
    start = end = None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        corr = (e.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            ops.append((name, ts, dur, cat))
            op_ids.append(corr)
        elif cat in HOST_CATS:
            host.append((cat, name, ts, dur))
            if cat in ("cuda_runtime", "cuda_driver") and corr is not None:
                launch_at[corr] = ts
            if cat == "user_annotation" and name == WINDOW:
                start, end = ts, ts + dur
    if start is None:
        raise RuntimeError(f"{path}: the trace has no {WINDOW!r} span")
    return Trace(ops, host, start, end, iterations, [launch_at.get(c) for c in op_ids])


def profile(run: Callable[[], None], iterations: int, path: Path) -> Trace:
    """Traces ``run`` (``iterations`` iterations, ending in a device sync)
    inside the ``perfbench.window`` span and reads the trace back."""
    import torch
    from torch.profiler import ProfilerActivity, record_function

    path.parent.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            run()
    prof.export_chrome_trace(str(path))
    return read_chrome_trace(path, iterations)
