"""Host milliseconds around the call of the step of ``make_train_step``
until it returns, no sync, the profiler off: the mean over the measured
window's steps."""

import statistics


def read(rec):
    ms = rec.host.get("dispatch_ms") if rec.kind == "train" else None
    return statistics.fmean(ms) if ms else None
