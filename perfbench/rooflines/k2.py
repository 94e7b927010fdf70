"""K2, the fused stem (``ops/stem.py`` → ``csrc/stem_pool_tc.cu``): the
7×7/2 conv of 3 channels to 64, folded BN, ReLU and the 3×3/2 max pool of
each of the pyramid's three levels, bf16. Bound by operations: 147
multiply-adds an output pixel and channel at the conv's stride-2 grid, on
the bf16 tensor cores; bytes: each level's bf16 input read once and its
pooled bf16 output written once."""

LEVELS = 3
KERNEL = "stem_pool_tc_kernel"


def work(b: int, h: int, w: int):
    """(FLOPs, bytes) of one serving batch of b h×w images."""
    flops = nbytes = 0.0
    for lv in range(LEVELS):
        hl, wl = h >> lv, w >> lv
        hc, wc = (hl - 1) // 2 + 1, (wl - 1) // 2 + 1
        hp, wp = (hc - 1) // 2 + 1, (wc - 1) // 2 + 1
        flops += 2.0 * b * hc * wc * 64 * 147
        nbytes += b * hl * wl * 3 * 2 + b * hp * wp * 64 * 2
    return flops, nbytes


def bound_s(b: int, h: int, w: int, peaks: dict):
    """(least seconds, "operations" or "bytes") of one batch's launches."""
    flops, nbytes = work(b, h, w)
    by_ops, by_bytes = flops / peaks["bf16_tensor_flops"], nbytes / peaks["hbm_bytes_per_s"]
    return max(by_ops, by_bytes), ("operations" if by_ops >= by_bytes else "bytes")
