"""Device kernels a training step, counted in the profiler's trace."""


def read(rec):
    if rec.kind != "train" or rec.trace is None:
        return None
    return rec.trace.launches() / rec.trace.iterations
