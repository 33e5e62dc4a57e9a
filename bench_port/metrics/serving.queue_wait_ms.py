"""Median wait of a /chat_pro request in the retrieval batcher's queue (ms), over every wait the batcher observed in the traced sub-window."""

from bench_port.harness import readers


def read(records):
    return readers.stage_median_ms(records, "stage.queue_wait.retrieval")
