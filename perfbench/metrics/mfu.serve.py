"""The serving step's share of the card's bf16 tensor-core peak: the
model FLOPs of the eval forward (counted on the reference at the cell's
shapes, so they read the same whatever implements them) of every batch of
the measured window, over the window's length."""


def read(rec):
    if rec.kind != "serve" or not rec.flops_per_iteration or not rec.window_s:
        return None
    rate = rec.flops_per_iteration * rec.iterations / rec.window_s
    return 100.0 * rate / rec.peaks["bf16_tensor_flops"]
