"""The share of the traced training window in which no operation ran on
the card."""


def read(rec):
    if rec.kind != "train" or rec.trace is None:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)
