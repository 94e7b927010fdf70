"""K1's share of its roofline: the least time of a batch's fused head
(``perfbench/rooflines/k1.py``) over its device time in the trace.
Nothing to read where no K1 kernel ran."""

from perfbench.rooflines import k1


def read(rec):
    if rec.kind != "serve" or rec.trace is None:
        return None
    times = rec.trace.kernels(lambda n: k1.KERNEL in n)
    if not times:
        return None
    h, w = rec.traffic["frame_hw"]
    bound, _ = k1.bound_s(rec.traffic["batch"], h, w, rec.config["widths"]["num_classes"],
                          rec.peaks)
    return 100.0 * bound * rec.trace.iterations / (sum(times) * 1e-6)
