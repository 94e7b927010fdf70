"""JF, the label-carrying jump flood (``ops/edt.py`` → ``csrc/jfa.cu``) of
one step's b crop×crop uint8 label maps: one launch a (round, direction).
Bound by operations: 5 float32 operations (two differences, two squares, a
sum) for every in-frame neighbour of every update, off the tensor cores;
bytes: the labels read once and the float32 distances written once."""

KERNEL = "jfa_step"
FLOPS_PER_CANDIDATE = 5


def launches(h: int, w: int):
    steps, s = [], 1
    while s < max(h, w):
        steps.append(s)
        s *= 2
    steps = steps[::-1] + [1]
    return [(ey * s, ex * s) for s in steps for ey in (-1, 0, 1) for ex in (-1, 0, 1)
            if (ey, ex) != (0, 0)]


def work(b: int, h: int, w: int, label_bytes: int = 1):
    pairs = sum(max(h - abs(dy), 0) * max(w - abs(dx), 0) for dy, dx in launches(h, w))
    return FLOPS_PER_CANDIDATE * b * pairs, b * h * w * (label_bytes + 4.0)


def bound_s(b: int, h: int, w: int, peaks: dict, label_bytes: int = 1):
    flops, nbytes = work(b, h, w, label_bytes)
    by_ops, by_bytes = flops / peaks["f32_flops"], nbytes / peaks["hbm_bytes_per_s"]
    return max(by_ops, by_bytes), ("operations" if by_ops >= by_bytes else "bytes")
