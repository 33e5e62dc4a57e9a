"""Time in the index.journal spans (encoding the rows, and appending them once the index's lock is held) under the ingest.upsert spans that ended in the traced sub-window, per thousand chunks upserted (ms)."""

from bench_port.harness import spans


def read(records):
    return spans.ms_per_kchunk(records, "index.journal", "ingest.upsert")
