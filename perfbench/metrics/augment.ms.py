"""Device milliseconds a step of the data layer: the device operations
launched inside the benchmark's ``bench.to_device`` and ``bench.augment``
spans (the upload of ``data/loader.py::to_device``; the crops, gamma and
JF's weights of ``data/device_augment.py::apply_augment``), read from the
traced run's profile."""

SPANS = ("bench.to_device", "bench.augment")


def read(rec):
    if rec.kind != "train" or rec.trace is None:
        return None
    return rec.trace.device_ms(lambda name: name in SPANS)
