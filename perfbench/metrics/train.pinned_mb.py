"""Megabytes of host memory that ``data/loader.py::to_device`` pins anew a
training step: the program's ``data.pinned_bytes`` counts in the traced
run's profile (``harness/spans.py``), over the steps, over 1e6."""

from perfbench.harness import spans


def read(rec):
    n = spans.counted(rec, "train", "data.pinned_bytes")
    return None if n is None else n / 1e6
