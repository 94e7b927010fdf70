"""Device milliseconds a training step in the convolution and GEMM kernels of
cuDNN, cuBLAS and CUTLASS (``perfbench/harness/kernels.py``), from the
trace."""

from perfbench.harness.kernels import is_conv


def read(rec):
    if rec.kind != "train" or rec.trace is None:
        return None
    times = rec.trace.kernels(is_conv)
    return sum(times) * 1e-3 / rec.trace.iterations if times else None
