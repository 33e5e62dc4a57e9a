"""Median time of the cross-encoder stage (retrieve.rerank), which returns host logits, in the traced sub-window (ms)."""

from bench_port.harness import readers


def read(records):
    return readers.stage_median_ms(records, "stage.retrieve.rerank")
