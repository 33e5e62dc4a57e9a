"""Median, over the retrieval batches that ended in the traced sub-window, of each batch's runtime.tokenize spans summed (ms): the query towers' and the cross-encoder's tokenizing and padding."""

from bench_port.harness import spans


def read(records):
    return spans.retrieval_batch_ms(records, ("runtime.tokenize",))
