"""K1, the fused serving head (``ops/seghead.py`` → ``csrc/seghead_tc.cu``):
BN → ReLU → 1×1 conv of the 128 decoder features to the classes, the ×4
bilinear upsample and the argmax, bf16 in, int8 labels out. Bound by bytes:
the bf16 features read once and the int8 labels written once (16 label
pixels a feature pixel); operations: the 1×1 conv on the bf16 tensor cores
plus 6 float32 operations a label pixel and class for the upsample and
argmax."""

KERNEL = "seghead_tc_kernel"
FEATURES = 128


def work(b: int, h: int, w: int, classes: int):
    """(tensor-core FLOPs, float32 FLOPs, bytes) of one batch whose images
    are h×w (features h/4 × w/4)."""
    n_pix = b * (h // 4) * (w // 4)
    return (2.0 * n_pix * FEATURES * classes, 6.0 * 16 * n_pix * classes,
            n_pix * FEATURES * 2 + 16.0 * n_pix)


def bound_s(b: int, h: int, w: int, classes: int, peaks: dict):
    tc, f32, nbytes = work(b, h, w, classes)
    by_ops = tc / peaks["bf16_tensor_flops"] + f32 / peaks["f32_flops"]
    by_bytes = nbytes / peaks["hbm_bytes_per_s"]
    return max(by_ops, by_bytes), ("operations" if by_ops >= by_bytes else "bytes")
