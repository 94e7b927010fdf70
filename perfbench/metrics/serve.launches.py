"""Device kernels a serving batch, counted in the profiler's trace."""


def read(rec):
    if rec.kind != "serve" or rec.trace is None:
        return None
    return rec.trace.launches() / rec.trace.iterations
