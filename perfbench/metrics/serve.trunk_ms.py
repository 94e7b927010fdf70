"""Device milliseconds a serving batch of the operations launched inside
the program's ``dcss.trunk`` spans, read from the traced run's profile by
correlation id (``harness/spans.py``)."""

from perfbench.harness import spans


def read(rec):
    return spans.device_ms(rec, "serve", "dcss.trunk")
