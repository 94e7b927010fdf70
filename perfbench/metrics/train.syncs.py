"""The host's waits on the card a training step inside the program's
spans (``harness/spans.py``): the benchmark's one sync after the traced
steps lies outside them and is not counted."""

from perfbench.harness import spans


def read(rec):
    return spans.syncs(rec, "train")
