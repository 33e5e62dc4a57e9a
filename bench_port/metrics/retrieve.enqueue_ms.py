"""Median, over the retrieval batches that ended in the traced sub-window, of each batch's runtime.launch and index.dispatch spans summed (ms): the host's time enqueueing the towers, the searches and the rerank."""

from bench_port.harness import spans


def read(records):
    return spans.retrieval_batch_ms(records, ("runtime.launch", "index.dispatch"))
