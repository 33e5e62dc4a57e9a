"""The ingest embeds' share of the card's peak (%): MiniLM's least time at the real tokens embedded in the traced sub-window, over the sub-window."""

from bench_port.harness import readers


def read(records):
    return readers.mfu_ingest(records)
