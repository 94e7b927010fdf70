"""Device milliseconds a training step of the operations launched inside
the program's ``dcss.backward`` span, read from the traced run's profile by
correlation id (``harness/spans.py``)."""

from perfbench.harness import spans


def read(rec):
    return spans.device_ms(rec, "train", "dcss.backward")
