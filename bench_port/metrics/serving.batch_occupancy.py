"""Requests per coalesced retrieve_batch call that started in the traced sub-window."""

from bench_port.harness import readers


def read(records):
    return readers.batch_occupancy(records)
