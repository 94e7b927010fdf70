"""JF's share of its roofline: the least time of a step's jump flood over
the batch's first-view label crops (``perfbench/rooflines/jf.py``) over
its launches' device time in the trace. Nothing to read where no JF
kernel ran."""

from perfbench.rooflines import jf


def read(rec):
    if rec.kind != "train" or rec.trace is None:
        return None
    times = rec.trace.kernels(lambda n: jf.KERNEL in n)
    if not times:
        return None
    crop = rec.traffic["crop"]
    bound, _ = jf.bound_s(rec.traffic["batch"], crop, crop, rec.peaks)
    return 100.0 * bound * rec.trace.iterations / (sum(times) * 1e-6)
