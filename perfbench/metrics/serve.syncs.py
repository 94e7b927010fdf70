"""The host's waits on the card a serving batch inside the program's
spans (``harness/spans.py``): the benchmark's own wait for each batch's
labels lies outside them and is not counted."""

from perfbench.harness import spans


def read(rec):
    return spans.syncs(rec, "serve")
