"""K2's share of its roofline: the least time of a batch's three stem
launches (``perfbench/rooflines/k2.py``) over their device time in the
trace. Nothing to read where no K2 kernel ran."""

from perfbench.rooflines import k2


def read(rec):
    if rec.kind != "serve" or rec.trace is None:
        return None
    times = rec.trace.kernels(lambda n: k2.KERNEL in n)
    if not times:
        return None
    h, w = rec.traffic["frame_hw"]
    bound, _ = k2.bound_s(rec.traffic["batch"], h, w, rec.peaks)
    return 100.0 * bound * rec.trace.iterations / (sum(times) * 1e-6)
