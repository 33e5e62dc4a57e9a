"""Median time of the catalogue hydration stage (retrieve.hydrate) in the traced sub-window (ms)."""

from bench_port.harness import readers


def read(records):
    return readers.stage_median_ms(records, "stage.retrieve.hydrate")
