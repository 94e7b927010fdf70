"""Host milliseconds around ``serve()`` until it returns, no sync, the
profiler off: the mean over the measured window's batches."""

import statistics


def read(rec):
    ms = rec.host.get("dispatch_ms") if rec.kind == "serve" else None
    return statistics.fmean(ms) if ms else None
