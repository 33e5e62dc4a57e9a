"""Garbage-collection pause of every generation, for the collections that ended in the traced sub-window, per second of it (ms/s)."""

from bench_port.harness import spans


def read(records):
    return spans.gc_ms_per_s(records)
