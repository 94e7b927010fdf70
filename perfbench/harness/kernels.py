"""Which device kernels count as convolution and GEMM work: those of
cuDNN, cuBLAS and CUTLASS, picked by name; the port's own kernels never."""

PATTERNS = ("conv", "gemm", "xmma", "cutlass", "cudnn", "wgrad", "dgrad", "fprop",
            "winograd", "implicit", "nchwtonhwc", "nhwctonchw")
OWN = ("stem_pool", "seghead", "jfa_step", "blend", "row_stats", "pos_sweep")


def is_conv(name: str) -> bool:
    n = name.lower()
    return any(p in n for p in PATTERNS) and not any(o in n for o in OWN)
