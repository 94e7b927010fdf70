"""The training step's share of the card's bf16 tensor-core peak: the
model FLOPs of the forward and backward (counted on the reference at the
cell's shapes; recompute not counted) of every step of the measured
window, over the window's length."""


def read(rec):
    if rec.kind != "train" or not rec.flops_per_iteration or not rec.window_s:
        return None
    rate = rec.flops_per_iteration * rec.iterations / rec.window_s
    return 100.0 * rate / rec.peaks["bf16_tensor_flops"]
