"""Median, over the retrieval batches that ended in the traced sub-window, of each batch's index.wait and runtime.wait spans summed (ms): how long the card keeps the host waiting on a readback."""

from bench_port.harness import spans


def read(records):
    return spans.retrieval_batch_ms(records, ("index.wait", "runtime.wait"))
