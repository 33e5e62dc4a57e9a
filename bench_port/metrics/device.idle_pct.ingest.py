"""Share of the traced sub-window in which no operation ran on the card (%), ingest cell."""

from bench_port.harness import readers


def read(records):
    return readers.idle_pct(records)
